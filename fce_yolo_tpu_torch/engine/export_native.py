"""Native-runtime export (reference ``fce_yolo_tpu/engine/export_native.py``):
the eval forward as the repo's two-file artifact, run by the zero-dependency
C++ interpreter ``native/infer/fy_infer.cpp``.

  model.fyir   line-based text IR: tensors, op records, graph I/O
  model.fybin  raw little-endian blob of every constant, referenced by offset

The JAX package traces its forward to a jaxpr; the port exports a folded,
float32, eval-mode copy of the model with ``torch.export`` on the CPU,
decomposes it to core ATen and translates each node into the interpreter's
op set (the JAX exporter's ``_SUPPORTED``). Nodes that do not depend on the
input (weights, anchors, strides) are evaluated here and written as
constants. The artifact's input is NHWC float32 in [0, 1] at
(1, imgsz, imgsz, 3), as ``fy_infer``'s letterbox makes it; the model's NCHW
layout lives inside the graph. An ATen op outside the set raises here, at
export time, and names the op.

Lowerings that are not one to one: a transposed convolution becomes a
convolution over the input dilated by the stride, padded by ``k - 1 - p``,
with the kernel flipped and its in and out channels swapped; nearest
upsampling is ``broadcast_in_dim`` between two reshapes; max pooling is
``reduce_window_max`` (padded with -inf), average pooling
``reduce_window_sum`` and a division; softmax, mean, ``bmm``/``addmm``,
``select``, ``relu`` and an unfolded BatchNorm (the ResNet trunk's) are
spelled out in the set's own ops; a broadcast the interpreter cannot take
(operands of another rank) gets a reshape.
"""

from __future__ import annotations

import copy
import operator
from pathlib import Path

import numpy as np
import torch

__all__ = ["export_native", "NativeGraph"]

aten = torch.ops.aten

# ATen op -> fyir primitive, one to one: what the packaged models' eval graphs hold once decomposed
_BINARY = {aten.add.Tensor: "add", aten.sub.Tensor: "sub", aten.mul.Tensor: "mul", aten.div.Tensor: "div"}
_UNARY = {aten.sigmoid.default: "logistic"}
_IDENTITY = {aten.clone.default}
_RESHAPE = {aten.view.default, aten._unsafe_view.default, aten.unsqueeze.default, aten.squeeze.dims}
_SKIP = {aten._assert_tensor_metadata.default}


def _fmt(xs) -> str:
    return ",".join(str(int(v)) for v in xs)


class NativeGraph(torch.nn.Module):
    """The graph an artifact holds: NHWC float32 [0, 1] in, the JAX
    artifact's outputs per task (``fce_yolo_tpu/engine/export_native.py:199-206``):
    detect, OBB and pose ``(preds,)``, segment ``(preds, proto)`` with the
    proto NHWC (1, Hp, Wp, nm), classify ``(probs,)``."""

    def __init__(self, model: torch.nn.Module, task: str):
        super().__init__()
        self.model, self.task = model, task

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        out = self.model(x.permute(0, 3, 1, 2))
        if self.task == "classify":
            return (out["probs"],)
        if self.task == "segment":
            return out["preds"], out["proto"].permute(0, 2, 3, 1)
        return (out["preds"],)


class _Dyn:
    """A value that depends on the input: its tensor id in the artifact and its shape."""

    __slots__ = ("id", "shape")

    def __init__(self, id_: int, shape):
        self.id, self.shape = id_, tuple(int(d) for d in shape)


class _Unusable:
    """A value the runtime cannot hold (max pooling's indices)."""

    def __init__(self, what: str):
        self.what = what


class _Writer:
    """The artifact's lines and constant blob; tensors get ids as they are made."""

    def __init__(self):
        self.lines: list[str] = []
        self.blob = bytearray()
        self.next_id = 0

    def fresh(self) -> int:
        self.next_id += 1
        return self.next_id - 1

    def const(self, arr) -> int:
        arr = np.ascontiguousarray(np.asarray(arr, np.float32))  # integer tables are exact in float32
        i = self.fresh()
        off = len(self.blob)
        self.blob += arr.tobytes()
        self.lines.append(f"const {i} {arr.ndim} {_fmt(arr.shape) if arr.ndim else ''} {off} {arr.nbytes}")
        return i

    def eqn(self, prim: str, ins: list[int], shapes: list[tuple[int, ...]], extra: str = "") -> list[int]:
        outs = []
        for s in shapes:
            o = self.fresh()
            self.lines.append(f"shape {o} {len(s)} {_fmt(s)}".rstrip())
            outs.append(o)
        self.lines.append(f"eqn {prim} {len(ins)} {' '.join(map(str, ins))} {len(outs)} "
                          f"{' '.join(map(str, outs))} {extra}".rstrip())
        return outs


class _Translator:
    """Walks a decomposed ``ExportedProgram``: constants are torch tensors
    (evaluated here), values that depend on the input are ``_Dyn``."""

    def __init__(self, ep: torch.export.ExportedProgram):
        self.ep = ep
        self.w = _Writer()
        self.env: dict[str, object] = {}
        self.consts: dict = {}  # id(tensor) or a scalar -> (emitted const id, the tensor kept alive)

    # ------------------------------------------------------------ values
    @staticmethod
    def is_dyn(v) -> bool:
        return isinstance(v, _Dyn)

    def has_dyn(self, v) -> bool:
        if isinstance(v, (list, tuple)):
            return any(self.has_dyn(x) for x in v)
        if isinstance(v, dict):
            return any(self.has_dyn(x) for x in v.values())
        return isinstance(v, (_Dyn, _Unusable))

    def value(self, a):
        if isinstance(a, torch.fx.Node):
            v = self.env[a.name]
            if isinstance(v, _Unusable):
                raise NotImplementedError(f"{v.what} is used by the graph; the native runtime has no such value")
            return v
        if isinstance(a, (list, tuple)):
            return type(a)(self.value(x) for x in a)
        if isinstance(a, dict):
            return {k: self.value(x) for k, x in a.items()}
        return a

    def ref(self, v) -> int:
        """The tensor id of ``v``: a value, or a constant written on first use."""
        if self.is_dyn(v):
            return v.id
        key = id(v) if isinstance(v, torch.Tensor) else ("scalar", float(v))
        if key not in self.consts:
            t = torch.as_tensor(v, dtype=torch.float32)
            self.consts[key] = (self.w.const(t.detach().float().cpu().numpy()), v)
        return self.consts[key][0]

    @staticmethod
    def shape_of(v) -> tuple[int, ...]:
        return v.shape if isinstance(v, _Dyn) else tuple(torch.as_tensor(v).shape)

    def eqn(self, prim: str, ins: list, shape: tuple[int, ...], extra: str = "") -> _Dyn:
        (o,) = self.w.eqn(prim, [self.ref(v) for v in ins], [tuple(shape)], extra)
        return _Dyn(o, shape)

    def reshape(self, v, shape: tuple[int, ...]):
        shape = tuple(int(s) for s in shape)
        if not self.is_dyn(v):
            return torch.as_tensor(v).reshape(shape)
        return v if v.shape == shape else self.eqn("reshape", [v], shape)

    def transpose(self, v, perm: list[int]):
        shape = tuple(self.shape_of(v)[p] for p in perm)
        return self.eqn("transpose", [v], shape, f"perm={_fmt(perm)}")

    def binary(self, prim: str, a, b, shape: tuple[int, ...]):
        """``prim`` with the operands brought to the output's rank (the
        interpreter broadcasts size-1 dims of equal ranks only)."""
        ins = []
        for v in (a, b):
            s = self.shape_of(v)
            if len(s) < len(shape) and int(np.prod(s)) != 1:
                v = self.reshape(v, (1,) * (len(shape) - len(s)) + s)
            ins.append(v)
        return self.eqn(prim, ins, shape)

    # ------------------------------------------------------------- walk
    def run(self, in_shape: tuple[int, ...], meta_line: str) -> tuple[str, bytes]:
        specs = {spec.arg.name: spec for spec in self.ep.graph_signature.input_specs}
        in_id = None
        for node in self.ep.graph.nodes:
            if node.op == "placeholder":
                spec = specs[node.name]
                if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
                    in_id = self.w.fresh()
                    self.env[node.name] = _Dyn(in_id, node.meta["val"].shape)
                elif spec.target in self.ep.state_dict:
                    self.env[node.name] = self.ep.state_dict[spec.target]
                else:
                    self.env[node.name] = self.ep.constants[spec.target]
            elif node.op == "call_function":
                self.env[node.name] = self.node(node)
            elif node.op == "output":
                outs = [self.ref(self.value(a)) for a in node.args[0]]
        w = self.w
        w.lines.insert(0, meta_line)
        w.lines.insert(1, f"input {in_id} 4 {_fmt(in_shape)}")
        w.lines += [f"output {o}" for o in outs]
        return "FYIR 1\n" + "\n".join(w.lines) + "\n", bytes(w.blob)

    def node(self, node: torch.fx.Node):
        t = node.target
        if t in _SKIP:
            return None
        args, kwargs = self.value(node.args), self.value(node.kwargs)
        if t is operator.getitem:
            return args[0][args[1]]
        if not self.has_dyn(args) and not self.has_dyn(kwargs):
            with torch.no_grad():  # the constant folding: weights, anchors, strides
                return t(*args, **kwargs)
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor) and not val.dtype.is_floating_point:
            raise NotImplementedError(f"ATen op {t} makes a {val.dtype} tensor from the input; the native runtime "
                                      "holds float32 only")
        if t in _BINARY:
            if kwargs.get("alpha", 1) != 1:
                raise NotImplementedError(f"ATen op {t} with alpha is not exported")
            return self.binary(_BINARY[t], args[0], args[1], tuple(val.shape))
        if t in _UNARY:
            return self.eqn(_UNARY[t], [args[0]], tuple(val.shape))
        if t in _IDENTITY:
            return args[0]
        if t in _RESHAPE:
            return self.reshape(args[0], tuple(val.shape))
        lower = getattr(self, "op_" + getattr(t, "__name__", "").replace(".", "_"), None)
        if lower is None:
            raise NotImplementedError(
                f"ATen op {t} is not in the native runtime's op set (native/infer/fy_infer.cpp); "
                "lower it in fce_yolo_tpu_torch/engine/export_native.py")
        return lower(val, *args, **kwargs)

    # ------------------------------------------------------- lowerings
    def op_permute_default(self, val, x, dims):
        return self.transpose(x, [d % len(dims) for d in dims])

    def op_expand_default(self, val, x, size, **_):
        shape = tuple(val.shape)
        r = len(self.shape_of(x))
        return self.eqn("broadcast_in_dim", [x], shape, f"bdims={_fmt(range(len(shape) - r, len(shape))) or '-'}")

    def op_relu_default(self, val, x):
        return self.binary("max", x, 0.0, tuple(val.shape))

    def op_constant_pad_nd_default(self, val, x, pad, value=0.0):
        rank = len(self.shape_of(x))
        pairs = [(0, 0)] * rank
        for i in range(len(pad) // 2):  # torch lists the last dimension first
            pairs[rank - 1 - i] = (pad[2 * i], pad[2 * i + 1])
        cfg = ";".join(f"{lo},{hi},0" for lo, hi in pairs)
        return self.eqn("pad", [x, float(value)], tuple(val.shape), f"cfg={cfg}")

    def op__native_batch_norm_legit_no_training_default(self, val, x, weight, bias, mean, var, momentum, eps):
        """Inference BatchNorm of a module the fold leaves (the ResNet trunk): one scale and one shift."""
        scale = weight.float() / torch.sqrt(var.float() + eps)
        shape = (1, -1) + (1,) * (len(self.shape_of(x)) - 2)
        y = self.binary("mul", x, scale.reshape(shape), tuple(val[0].shape))
        y = self.binary("add", y, (bias.float() - mean.float() * scale).reshape(shape), tuple(val[0].shape))
        return [y, _Unusable("batch norm's saved mean"), _Unusable("batch norm's saved variance")]

    def op_convolution_default(self, val, x, weight, bias, stride, padding, dilation, transposed, output_padding,
                               groups):
        if self.is_dyn(weight):
            raise NotImplementedError("a convolution whose weight depends on the input is not exported")
        w = weight.detach().float()
        if transposed:
            if groups != 1 or any(d != 1 for d in dilation):
                raise NotImplementedError("a grouped or dilated transposed convolution is not exported")
            k = w.shape[2:]
            w = w.flip(2, 3).transpose(0, 1)  # (in, out, kh, kw) -> (out, in, kh, kw), flipped spatially
            pads = ";".join(f"{kk - 1 - p},{kk - 1 - p + op}" for kk, p, op in zip(k, padding, output_padding))
            extra = f"strides=1,1 pad={pads} lhs_dil={_fmt(stride)} rhs_dil=1,1 groups=1"
        else:
            pads = ";".join(f"{p},{p}" for p in padding)
            extra = f"strides={_fmt(stride)} pad={pads} lhs_dil=1,1 rhs_dil={_fmt(dilation)} groups={groups}"
        # NHWC activations and OHWI weights: the interpreter's innermost loop over input channels reads
        # both contiguously
        n, c, h, wd = tuple(val.shape)
        xh = self.transpose(x, [0, 2, 3, 1])
        y = self.eqn("conv_general_dilated", [xh, w.permute(0, 2, 3, 1).contiguous()], (n, h, wd, c),
                     extra + " lhs_spec=0312 rhs_spec=0312 out_spec=0312")
        if bias is not None:
            y = self.binary("add", y, bias.detach().float().reshape(1, 1, 1, -1), (n, h, wd, c))
        return self.transpose(y, [0, 3, 1, 2])

    def op_cat_default(self, val, tensors, dim=0):
        return self.eqn("concatenate", list(tensors), tuple(val.shape), f"dim={dim % val.dim()}")

    def op_split_with_sizes_default(self, val, x, sizes, dim=0):
        shapes = [tuple(v.shape) for v in val]
        outs = self.w.eqn("split", [self.ref(x)], shapes, f"sizes={_fmt(sizes)} axis={dim % len(shapes[0])}")
        return [_Dyn(o, s) for o, s in zip(outs, shapes)]

    def op_slice_Tensor(self, val, x, dim=0, start=None, end=None, step=1):
        shape = self.shape_of(x)
        dim %= len(shape)
        lo, hi, st = slice(start, end, step).indices(shape[dim])
        starts = [0] * len(shape)
        limits = list(shape)
        strides = [1] * len(shape)
        starts[dim], limits[dim], strides[dim] = lo, hi, st
        return self.eqn("slice", [x], tuple(val.shape),
                        f"start={_fmt(starts)} limit={_fmt(limits)} stride={_fmt(strides)}")

    def op_select_int(self, val, x, dim, index):
        shape = self.shape_of(x)
        dim %= len(shape)
        index %= shape[dim]
        kept = shape[:dim] + (1,) + shape[dim + 1:]
        starts = [0] * len(shape)
        limits = list(shape)
        starts[dim], limits[dim] = index, index + 1
        s = self.eqn("slice", [x], kept, f"start={_fmt(starts)} limit={_fmt(limits)} stride={_fmt([1] * len(shape))}")
        return self.reshape(s, tuple(val.shape))

    def _reduce(self, prim: str, x, dims, keepdim: bool):
        shape = self.shape_of(x)
        dims = sorted({d % len(shape) for d in (dims if dims else range(len(shape)))})
        out = tuple(s for i, s in enumerate(shape) if i not in dims)
        r = self.eqn(prim, [x], out, f"axes={_fmt(dims)}")
        if keepdim:
            r = self.reshape(r, tuple(1 if i in dims else s for i, s in enumerate(shape)))
        return r, int(np.prod([shape[d] for d in dims]))

    def op_mean_dim(self, val, x, dims, keepdim=False, **_):
        s, n = self._reduce("reduce_sum", x, dims, keepdim)
        return self.binary("div", s, float(n), tuple(val.shape))

    def op__softmax_default(self, val, x, dim, half_to_float=False):
        shape = tuple(val.shape)
        m, _ = self._reduce("reduce_max", x, [dim], True)
        e = self.eqn("exp", [self.binary("sub", x, m, shape)], shape)
        s, _ = self._reduce("reduce_sum", e, [dim], True)
        return self.binary("div", e, s, shape)

    def op_bmm_default(self, val, a, b):
        return self.eqn("dot_general", [a, b], tuple(val.shape), "lc=2 rc=1 lb=0 rb=0")

    def op_addmm_default(self, val, bias, a, b, beta=1, alpha=1):
        if beta != 1 or alpha != 1:
            raise NotImplementedError("addmm with beta or alpha other than 1 is not exported")
        y = self.eqn("dot_general", [a, b], tuple(val.shape), "lc=1 rc=0 lb=- rb=-")
        return self.binary("add", y, bias, tuple(val.shape))

    @staticmethod
    def _window(kernel_size, stride, padding) -> tuple[list[int], str]:
        """A 2-D pooling window as ``reduce_window_*`` parameters over NCHW."""
        k = list(kernel_size) * (2 // len(kernel_size))
        s = list(stride or k) * (2 // len(stride or k))
        p = list(padding) * (2 // len(padding))
        pads = ";".join(f"{a},{a}" for a in [0, 0] + p)
        return k, f"win=1,1,{_fmt(k)} strides=1,1,{_fmt(s)} pad={pads}"

    def op_max_pool2d_with_indices_default(self, val, x, kernel_size, stride=(), padding=(0,), dilation=(1,),
                                           ceil_mode=False):
        if ceil_mode or any(d != 1 for d in dilation):
            raise NotImplementedError("max pooling with ceil_mode or dilation is not exported")
        _, extra = self._window(kernel_size, stride, padding)
        out = self.eqn("reduce_window_max", [x], tuple(val[0].shape), extra)  # pads with -inf
        return [out, _Unusable("max pooling's indices")]

    def op_avg_pool2d_default(self, val, x, kernel_size, stride=(), padding=(0,), ceil_mode=False,
                              count_include_pad=True, divisor_override=None):
        if ceil_mode or divisor_override or (any(padding) and not count_include_pad):
            raise NotImplementedError("average pooling with ceil_mode, a divisor or padding left out is not exported")
        k, extra = self._window(kernel_size, stride, padding)
        s = self.eqn("reduce_window_sum", [x], tuple(val.shape), extra)  # pads with 0
        return self.binary("div", s, float(k[0] * k[1]), tuple(val.shape))

    def op_upsample_nearest2d_vec(self, val, x, output_size=None, scale_factors=None):
        n, c, h, w = self.shape_of(x)
        ho, wo = val.shape[2:]
        if ho % h or wo % w:
            raise NotImplementedError(f"nearest upsampling {h}x{w} -> {ho}x{wo} is not by a whole factor")
        sh, sw = ho // h, wo // w
        y = self.reshape(x, (n, c, h, 1, w, 1))
        y = self.eqn("broadcast_in_dim", [y], (n, c, h, sh, w, sw), "bdims=0,1,2,3,4,5")
        return self.reshape(y, (n, c, ho, wo))


def export_native(model: torch.nn.Module, path: str | Path, imgsz: int = 640, task: str | None = None) -> Path:
    """Write ``<path>.fyir`` + ``<path>.fybin`` for ``model`` (the port's
    ``DetectionModel``, any dtype or device; a folded float32 eval copy is
    exported on the CPU) at (1, imgsz, imgsz, 3). The ``meta`` line carries
    the task, the class count and a pose head's keypoint shape, as the JAX
    artifact's does. Returns the .fyir path."""
    from fce_yolo_tpu_torch.nn.model import fold_conv_bn

    task = task or model.task
    m = fold_conv_bn(copy.deepcopy(model).float().cpu()).eval()
    ep = torch.export.export(NativeGraph(m, task), (torch.zeros(1, imgsz, imgsz, 3),), strict=False)
    ep = ep.run_decompositions()
    meta = f"meta task={task} nc={model.spec.nc}"
    if task == "pose":
        meta += f" kpt={_fmt(model.detect.kpt_shape)}"
    text, blob = _Translator(ep).run((1, imgsz, imgsz, 3), meta)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    ir = path.with_suffix(".fyir")
    ir.write_text(text)
    path.with_suffix(".fybin").write_bytes(blob)
    return ir
