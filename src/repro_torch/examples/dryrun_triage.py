"""Perf triage of a dry-run cell with the paper's disparity machinery:
per-phase static costs -> CRNM severity bands -> rough-set root causes.
The twin of the reference's ``examples/dryrun_triage.py``: the (2, 4)
mesh is a fake 8-rank world in this process and the model is on
``meta``, so nothing is allocated; the analyzer runs on the card unless
``--device`` says otherwise (without a card the default fails), on the
kernel lane unless ``--distance-backend`` names another (``numpy``: the
exact host lane).

    PYTHONPATH=src python -m repro_torch.examples.dryrun_triage \\
        [--arch chatglm3-6b] [--device cpu|cuda] \\
        [--distance-backend kernel|torch|numpy]
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of the analyzer (default: cuda)")
    ap.add_argument("--distance-backend", default="kernel",
                    choices=("kernel", "torch", "numpy"))
    args = ap.parse_args(argv)

    import torch.distributed as dist

    import repro_torch.configs.base as base
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.static_analyzer import report_cell

    device = None if args.distance_backend == "numpy" \
        else resolve_device(args.device)
    fake_world(8)
    try:
        mesh = make_mesh((2, 4), ("data", "model"))
        shape = base.InputShape("triage", args.seq, args.batch, "train")
        cfg = get_arch(args.arch).smoke.with_(dtype="float32",
                                              param_dtype="float32")
        print(report_cell(cfg, shape, mesh, device=device,
                          distance_backend=args.distance_backend))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
