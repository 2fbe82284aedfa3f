"""Command-line interface.

Port of goicp_tpu/cli.py.  `run-pair` mirrors the reference binary's argv
contract (README.md:17, jly_main.cpp:181-229):
    GoICP <MODEL> <DATA> <ND_DOWNSAMPLED> <CONFIG> <OUTPUT> <PAIR>
plus `run-bo1` (the bo1_GoICP.py sweep) and `run-demo` (demo/demo.m).
Every subcommand runs on the CUDA card unless given `--device cpu`.

    python -m goicp_tpu_torch.cli run-pair MODEL DATA N CONFIG OUTPUT PAIR
    python -m goicp_tpu_torch.cli run-bo1 DATA_ROOT CONFIG \
        --engine host|device|fused|device-batch
    python -m goicp_tpu_torch.cli run-demo MODEL DATA [N]
"""

from __future__ import annotations

import argparse
import sys

from goicp_tpu_torch.config import GoICPConfig


def _device_option(p):
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain torch versions)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="goicp-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run-pair", help="register one cavity pair")
    p.add_argument("model")
    p.add_argument("data")
    p.add_argument("nd_downsampled", type=int)
    p.add_argument("config")
    p.add_argument("output")
    p.add_argument("pair", type=int, nargs="?", default=1)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--cfpfh-dir", default=None)
    p.add_argument("--chains-dir", default=None)
    p.add_argument("--ref-proteins-dir", default=None)
    p.add_argument("--engine", choices=["host", "device"], default="host")
    p.add_argument("-q", "--quiet", action="store_true")
    _device_option(p)

    b = sub.add_parser("run-bo1", help="run the BO1 sweep")
    b.add_argument("data_root")
    b.add_argument("config")
    b.add_argument("--out-dir", default="bo1_out")
    b.add_argument("--kind", choices=["similar", "dissimilar"],
                   default="similar")
    b.add_argument("--limit", type=int, default=None)
    b.add_argument("--start", type=int, default=0)
    b.add_argument("--no-rmsd", action="store_true")
    b.add_argument("--engine",
                   choices=["host", "device", "device-batch", "fused"],
                   default="host")
    b.add_argument("-q", "--quiet", action="store_true")
    _device_option(b)

    d = sub.add_parser("run-demo", help="run the bunny/random demo")
    d.add_argument("model")
    d.add_argument("data")
    d.add_argument("nd_downsampled", type=int, nargs="?", default=1000)
    d.add_argument("--config", default=None)
    d.add_argument("--output", default="output.txt")
    d.add_argument("--engine", choices=["host", "device"], default="device")
    d.add_argument("-q", "--quiet", action="store_true")
    _device_option(d)

    args = ap.parse_args(argv)

    if args.cmd == "run-pair":
        from goicp_tpu_torch.pipeline.pair import run_pair
        cfg = GoICPConfig.from_file(args.config)
        res = run_pair(args.model, args.data, cfg,
                       nd_downsampled=args.nd_downsampled,
                       output_file=args.output, pair_id=args.pair,
                       out_dir=args.out_dir, cfpfh_dir=args.cfpfh_dir,
                       chains_dir=args.chains_dir,
                       ref_proteins_dir=args.ref_proteins_dir,
                       verbose=not args.quiet, engine=args.engine,
                       device=args.device)
        reg = res.registration
        print(f"Error: {reg.error:.6g}")
        print(f"Compatibilities: {reg.compatibilities}")
        if res.rmsd is not None:
            print(f"RMSD: {res.rmsd:.4f}")
        return 0

    if args.cmd == "run-bo1":
        from goicp_tpu_torch.pipeline.sweep import run_sweep
        cfg = GoICPConfig.from_file(args.config)
        run_sweep(args.data_root, cfg, args.out_dir, kind=args.kind,
                  limit=args.limit, start=args.start,
                  with_rmsd=not args.no_rmsd, verbose=not args.quiet,
                  engine=args.engine, device=args.device)
        return 0

    from goicp_tpu_torch.pipeline.demo import run_demo
    cfg = GoICPConfig.from_file(args.config) if args.config else None
    reg = run_demo(args.model, args.data, args.nd_downsampled, cfg,
                   output_file=args.output, verbose=not args.quiet,
                   engine=args.engine, device=args.device)
    print(f"Error: {reg.error:.6g}  time {reg.time_s:.2f}s "
          f"evals {reg.bound_evals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
