"""Command-line entry points of the port (``gpras_tpu/__main__.py``'s, with the
same arguments, plus ``--device``: ``cuda`` by default, ``cpu`` to run on the
host).

Usage:
    python -m gpras_tpu_torch run <config.json>          # end-to-end pipeline
    python -m gpras_tpu_torch cv <config.json> <sweep>   # kernels|modes|inducing|optimizers
    python -m gpras_tpu_torch select-events <sst.pq> <out.stac.json> [...]
    python -m gpras_tpu_torch make-runs <settings.json>
    python -m gpras_tpu_torch predict <model.npz> <in.npz> <out.npz> \
        --hf-pre <hf.npz> --lf-pre <lf.npz>        # serve saved artifacts
    python -m gpras_tpu_torch describe-config            # config field reference

``make-runs`` writes text and DSS files on the host and takes no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="gpras_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_device(p: argparse.ArgumentParser) -> None:
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda)")

    run_p = sub.add_parser("run", help="run the end-to-end pipeline")
    run_p.add_argument("config")
    add_device(run_p)

    cv_p = sub.add_parser("cv", help="cross-validation sweeps")
    cv_p.add_argument("config")
    cv_p.add_argument("sweep", choices=["kernels", "modes", "inducing", "optimizers"])
    add_device(cv_p)

    sel_p = sub.add_parser("select-events", help="select train/test storms from SST parquet")
    sel_p.add_argument("parquet")
    sel_p.add_argument("out_stac")
    sel_p.add_argument("--n-train", type=int, default=35)
    sel_p.add_argument("--n-test", type=int, default=14)
    sel_p.add_argument("--target-rps", default="2,5,10,25,50,100,200,500,1000,2000")
    sel_p.add_argument("--s3-prefix", default="s3://events")
    sel_p.add_argument("--test-rp-range", default="5,2000")
    add_device(sel_p)

    mk_p = sub.add_parser("make-runs", help="generate HEC-RAS runs for selected events")
    mk_p.add_argument("settings")

    pr_p = sub.add_parser(
        "predict", help="serve predictions from saved artifacts")
    pr_p.add_argument("model", help="GPRAS checkpoint (.npz)")
    pr_p.add_argument("input", help="npz with LF cell fields under --key")
    pr_p.add_argument("output", help="output npz (field + field_var)")
    pr_p.add_argument("--hf-pre", required=True,
                      help="high-fidelity PreProcessor artifact")
    pr_p.add_argument("--lf-pre", required=True,
                      help="low-fidelity PreProcessor artifact")
    pr_p.add_argument("--key", default="fields",
                      help="array key in the input npz (default: fields)")
    pr_p.add_argument("--batch", type=int, default=4096,
                      help="events per device dispatch")
    add_device(pr_p)

    sub.add_parser("describe-config", help="print the config field reference")

    args = parser.parse_args(argv)

    if args.cmd == "run":
        from gpras_tpu_torch.pipeline.config import Config
        from gpras_tpu_torch.pipeline.pipeline import pipeline

        summary = pipeline(Config.from_file(args.config), device=args.device)
        print(json.dumps(summary, indent=2, default=str))
    elif args.cmd == "cv":
        from gpras_tpu_torch.pipeline import cross_validation as cv

        cv.setup(args.config, args.device)
        {"kernels": cv.run_kernels, "modes": cv.run_spatial_modes,
         "inducing": cv.run_inducing_points,
         "optimizers": cv.run_optimization_method}[args.sweep](args.config, args.device)
    elif args.cmd == "select-events":
        from gpras_tpu_torch.pipeline.event_selection import EventSelection, write_events_stac

        rp_range = [float(v) for v in args.test_rp_range.split(",")]
        sel = EventSelection(args.parquet, test_rp_range=rp_range, device=args.device)
        storms, _ = sel.run_selection(
            args.n_train, args.n_test,
            [float(v) for v in args.target_rps.split(",")])
        write_events_stac(storms, args.s3_prefix, args.out_stac)
        print(f"wrote {args.out_stac}")
    elif args.cmd == "make-runs":
        from gpras_tpu_torch.pipeline.run_maker import make_runs_from_selected_events

        manifest = make_runs_from_selected_events(args.settings)
        print(f"created {len(manifest)} runs")
    elif args.cmd == "predict":
        import numpy as np

        from gpras_tpu_torch.gp.serving import PosteriorPredictor

        server = PosteriorPredictor(args.model,
                                    hf_preprocessor_path=args.hf_pre,
                                    lf_preprocessor_path=args.lf_pre,
                                    device=args.device)
        with np.load(args.input) as z:
            if args.key not in z:
                raise SystemExit(
                    f"key {args.key!r} not in {args.input} "
                    f"(has: {', '.join(z.files)})")
            fields = np.asarray(z[args.key])
        if fields.ndim != 2:
            raise SystemExit(f"--key {args.key!r} must be a 2-D "
                             f"(events, cells) array, got {fields.shape}")
        means, variances = [], []
        for i in range(0, fields.shape[0], args.batch):
            f, fv = server.predict_field(fields[i:i + args.batch])
            means.append(f)
            variances.append(fv)
        np.savez_compressed(args.output,
                            field=np.concatenate(means),
                            field_var=np.concatenate(variances))
        print(f"wrote {args.output}: {fields.shape[0]} events -> "
              f"{means[0].shape[1]} cells")
    elif args.cmd == "describe-config":
        from gpras_tpu_torch.pipeline.config import Config

        print(Config.describe())
    return 0


if __name__ == "__main__":
    sys.exit(main())
