"""Experiment CLI of the port: ``python -m fce_yolo_tpu_torch.experiments <cmd> ...``
(reference ``python -m fce_yolo_tpu.experiments``, the fork's script-level
CLIs). Training runs on the card unless ``--device`` names another.

  train <model_type> --scale s --data d.yaml [--iou-type WIoU] [--batch N] [--device cpu] ...
  compare <m1> <m2> ... --scale s --data d.yaml     # train several, table
  ablation --scale m --data d.yaml [--models a,b,c] [--clean]
  figures --project runs/detect --scale m           # tables, paper figures, per-run grids
  inspect <checkpoint_dir>                          # FCE weight diagnosis
"""

from __future__ import annotations

import argparse


def _add_train_args(p):
    p.add_argument("--scale", default="s", choices=list("nsmlx"))
    p.add_argument("--data", required=True)
    p.add_argument("--iou-type", default=None, choices=["CIoU", "DIoU", "GIoU", "WIoU"])
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--project", default="runs/detect")
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--single-stage", action="store_true", help="skip the stage-1 warmup")
    p.add_argument("--device", default="cuda", help="torch device to train on (default: the card)")


def _train_cfg(args):
    from fce_yolo_tpu_torch.experiments import TrainConfig, apply_overrides

    cfg = TrainConfig(data=args.data, project=args.project)
    overrides = {
        k: getattr(args, k)
        for k in ("batch", "imgsz", "workers", "epochs")
        if getattr(args, k) is not None
    }
    if args.iou_type:
        overrides["iou_type"] = args.iou_type
    return apply_overrides(cfg, overrides)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fce_yolo_tpu_torch.experiments")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train one registry variant")
    p.add_argument("model_type")
    _add_train_args(p)

    p = sub.add_parser("compare", help="train several variants and tabulate")
    p.add_argument("model_types", nargs="+")
    _add_train_args(p)

    p = sub.add_parser("ablation", help="fair M1->M4 ablation")
    _add_train_args(p)
    p.add_argument("--models", default=None, help="comma list; default: full M1-M4")
    p.add_argument("--clean", action="store_true")

    p = sub.add_parser("figures", help="regenerate the comparison tables and figures")
    p.add_argument("--project", default="runs/detect")
    p.add_argument("--scale", default="m")
    p.add_argument("--models", default="baseline,bifpn,fce,fce_wiou")
    p.add_argument("--out", default="figures")

    p = sub.add_parser("inspect", help="inspect FCE weights in a checkpoint")
    p.add_argument("checkpoint")

    args = ap.parse_args(argv)

    if args.cmd == "train":
        from dataclasses import replace

        from fce_yolo_tpu_torch.experiments import ExperimentTrainer, get_model_config

        mc = get_model_config(args.model_type)
        if args.single_stage:
            mc = replace(mc, stage1=None)
        out = ExperimentTrainer(mc, scale=args.scale, train_cfg=_train_cfg(args), device=args.device).train()
        print(f"done: {out['save_dir']} best_fitness={out['best_fitness']:.4f}")
        return out

    if args.cmd == "compare":
        from fce_yolo_tpu_torch.experiments import ExperimentTrainer, ablation_table, format_table, get_model_config

        runs = {}
        for mt in args.model_types:
            mc = get_model_config(mt)
            out = ExperimentTrainer(mc, scale=args.scale, train_cfg=_train_cfg(args), device=args.device).train()
            runs[mt] = out["save_dir"]
        table = ablation_table(runs)
        print(format_table(table))
        return table

    if args.cmd == "ablation":
        from fce_yolo_tpu_torch.experiments import run_ablation

        models = args.models.split(",") if args.models else None
        return run_ablation(_train_cfg(args), scale=args.scale, models=models, clean=args.clean, device=args.device)

    if args.cmd == "figures":
        from pathlib import Path

        from fce_yolo_tpu_torch.experiments import MODEL_CONFIGS
        from fce_yolo_tpu_torch.experiments.figures import produce_report
        from fce_yolo_tpu_torch.utils.plotting import plot_results

        runs = {}
        for name in args.models.split(","):
            mc = MODEL_CONFIGS[name]
            d = Path(args.project) / mc.get_result_path(args.scale)
            if (d / "results.csv").exists():
                runs[name] = d
        report = produce_report(runs, args.out, scale=args.scale, verbose=False)
        report["written"] += [f for f in map(plot_results, runs.values()) if f]
        print("\n".join(report["written"]))
        return report

    if args.cmd == "inspect":
        from fce_yolo_tpu_torch.experiments import inspect_checkpoint

        return inspect_checkpoint(args.checkpoint)


if __name__ == "__main__":
    main()
