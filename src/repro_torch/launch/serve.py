"""Serving launcher: batched prefill + interleaved decode through the
instrumented ServeEngine on the port's model (docs/serving.md).

The twin of the reference's ``repro.launch.serve``, with the same flags
plus ``--device``.  Generated traffic (skewed arrivals, bucketed prompt
lengths, optional hot-prompt repetition and sticky sessions) runs through
the model on per-lane decode states, every step emitting one serving
region trace row; ``--trace`` saves the artifact, which the analyzer
reads, and ``--spool-dir`` streams it to a trace spool that a second
process tails while the server runs::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
        --lanes 4 --requests 8 --prompt-len 512 --chunk 256 --gen 32 \\
        --trace serve.npz
    PYTHONPATH=src python -m repro_torch.cli.analyze_trace serve.npz
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --lanes 4 --requests 8 --prompt-len 64 --gen 16 --spool-dir spool &
    PYTHONPATH=src python -m repro_torch.cli.watch_trace spool --follow
    PYTHONPATH=src python -m repro_torch.launch.serve --arch st-100m \\
        --smoke --device cpu

The model runs on the card (its RMSNorm and attention or WKV-6 through
the hand-written CUDA kernels) unless ``--device cpu`` asks for the
kernels' plain versions on the host; without a card the default fails.
Families without multi-token cache writes (rwkv6-3b's ssm) clamp
``--chunk`` to 1, as the reference does.  Weights are random, drawn from
a ``torch.Generator`` seeded with ``--seed``.
Reported throughput excludes the warmup (one untimed call per
steady-state shape before the timed section) and splits prefill from
decode: each phase's tokens over that phase's own region wall.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Tuple

from repro_torch.configs import get_arch
from repro_torch.models import build
from repro_torch.scenarios.traffic import TrafficConfig, generate_traffic
from repro_torch.serve import (ServeConfig, ServeEngine, TorchBackend,
                               supports_chunk)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="st-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--lanes", type=int, default=2,
                    help="concurrent batch lanes (trace process axis)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt length bucket (single-bucket traffic)")
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8,
                    help="prefill chunk (clamped to 1 on families "
                         "without multi-token cache writes)")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean request arrivals per engine step")
    ap.add_argument("--hot-fraction", type=float, default=0.0,
                    help="fraction of requests replaying one hot prompt")
    ap.add_argument("--sessions", type=int, default=0,
                    help="sticky sessions (0 = none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="save the serving RegionTrace artifact here "
                         "(replayable via python -m "
                         "repro_torch.cli.analyze_trace)")
    ap.add_argument("--spool-dir", default=None, metavar="DIR",
                    help="stream per-step traces to a TraceSpool in DIR, "
                         "flushed every 8 engine steps (tail it live with "
                         "python -m repro_torch.cli.watch_trace DIR "
                         "--follow)")
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: cuda)")
    return ap


def run(args: argparse.Namespace, step_hook=None
        ) -> Tuple[ServeEngine, TorchBackend]:
    """Build the model and the traffic, serve it, finalize the trace.
    ``step_hook(engine, step, step_trace)`` runs after each engine step,
    before its trace is spooled (``ServeEngine``'s seam)."""
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    api = build(cfg, args.device)
    model = api.init(args.seed)

    chunk = args.chunk if supports_chunk(cfg) else 1
    chunk = min(chunk, args.prompt_len)
    traffic = generate_traffic(TrafficConfig(
        n_requests=args.requests,
        arrival_rate=args.arrival_rate,
        length_buckets=(args.prompt_len,), length_mix=(1.0,),
        gen_len=args.gen,
        hot_fraction=args.hot_fraction,
        sessions=args.sessions,
        vocab=cfg.vocab), seed=args.seed)
    max_len = args.prompt_len + args.gen + 1

    backend = TorchBackend(cfg, api, model, lanes=args.lanes,
                           max_len=max_len, prefill_chunk=chunk,
                           seed=args.seed)
    engine = ServeEngine(
        ServeConfig(lanes=args.lanes, max_len=max_len, prefill_chunk=chunk,
                    trace_path=args.trace, trace_spool_dir=args.spool_dir),
        traffic, backend, step_hook=step_hook)
    engine.run()
    return engine, backend


def summary(engine: ServeEngine) -> dict:
    """The reference launcher's JSON summary."""
    tp = engine.throughput()
    return {
        "steps": engine.step_idx,
        "requests_completed": int(tp["requests_completed"]),
        "tokens_generated": int(tp["tokens_decode"]),
        "tokens_prefill": int(tp["tokens_prefill"]),
        # warmup excluded: the backend warms the decode shapes before the
        # timed section
        "wall_s": tp["wall_s"],
        "tok_per_s": tp["tok_per_s"],
        "prefill_tok_per_s": tp["prefill_tok_per_s"],
        "decode_tok_per_s": tp["decode_tok_per_s"],
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    engine, backend = run(args)
    for rid in sorted(backend.outputs):
        print(f"request {rid}: {backend.outputs[rid]}")
    print(json.dumps(summary(engine)))
    if args.trace:
        print(f"trace artifact: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
