"""Serving entry point on one device (twin of ``repro.launch.serve``, co-located
and single-device): Poisson or replay traffic feeds the slot/KV-budget batch
manager; one decode step per tick interleaves prefill and decode and re-runs
the MicroEP scheduler in every MoE layer on the live batch's expert loads
(an RWKV-6 decoder carries each slot's recurrent state through K3s instead;
a dense decoder has no MoE layer and reports no balance).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --requests 4 --prompt-len 8 --gen 8 --max-batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch paper-gpt-32x1.3b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --smoke --device cpu           # dense; also gemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch paper-mixtral-16x2b --smoke --etp 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch paper-gpt-32x1.3b --smoke --device cpu --replacement \
      --repl-check-every 4 --telemetry-record --trace-out /tmp/load.npz \
      [--forecast-replacement | --replication]
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch paper-gpt-32x1.3b --smoke --device cpu --traffic trace \
      --trace /tmp/load.npz

Runs on the CUDA device unless ``--device cpu`` is given; weights are f32,
random from ``--seed``, drawn on the device.  ``--replacement`` (reactive;
``--forecast-replacement`` for the forecast planner) and ``--replication``
(the replica-topology controller) run the replacement hook in shadow mode
on one device: it checks and records its decisions, nothing migrates.
``--telemetry-record`` / ``--trace-out`` record each decode step's expert
loads; ``--traffic trace --trace FILE`` shapes arrivals from such a load
trace, ``--traffic replay --trace FILE.json`` replays a JSON request
trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..configs import get_config
from ..engine import ReplicationConfig, ServeConfig, TelemetryConfig
from ..serve import (ServingSession, load_trace, poisson_trace, replay_trace,
                     trace_requests)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--etp", type=int, default=None,
                    help="expert tensor parallelism (default the config's; "
                         "--smoke sets 1)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--traffic", default="poisson",
                    choices=["poisson", "replay", "trace"],
                    help="'trace' shapes non-stationary arrivals from a "
                         "recorded expert-load trace (TELEMETRY.md)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.25,
                    help="poisson arrival rate (requests per decode step)")
    ap.add_argument("--prompt-len", type=int, default=12,
                    help="max prompt length (sampled uniform in [len/2, len])")
    ap.add_argument("--gen", type=int, default=16,
                    help="max generation length (sampled like --prompt-len)")
    ap.add_argument("--trace", default=None,
                    help="JSON request trace for --traffic replay, or a "
                         "recorded load trace (npz/jsonl) for "
                         "--traffic trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="print the full ServeReport as JSON")
    ServeConfig.add_cli_args(ap)
    TelemetryConfig.add_cli_args(ap)
    ReplicationConfig.add_cli_args(ap)
    args = ap.parse_args(argv)
    serve_cfg = ServeConfig.from_cli_args(args)
    telemetry = TelemetryConfig.from_cli_args(args)
    replication = ReplicationConfig.from_cli_args(args)
    if telemetry.forecast_replacement and not serve_cfg.replacement:
        ap.error("--forecast-replacement selects the trigger policy of the "
                 "replacement hook; enable the hook with --replacement")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.etp is not None:
        cfg = dataclasses.replace(cfg, etp=args.etp)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    # grow the default cache to fit the requested lengths, but never
    # override an explicit --max-seq / --kv-budget
    if (serve_cfg.max_seq == ServeConfig().max_seq
            and serve_cfg.kv_budget is None
            and serve_cfg.max_seq < args.prompt_len + args.gen):
        serve_cfg = dataclasses.replace(
            serve_cfg, max_seq=args.prompt_len + args.gen)
        print(f"note: default --max-seq grown to {serve_cfg.max_seq} to fit "
              f"--prompt-len {args.prompt_len} + --gen {args.gen}")

    if args.traffic == "trace":
        if not args.trace:
            ap.error("--traffic trace needs --trace LOADTRACE.npz")
        requests = trace_requests(args.trace, cfg.vocab, rate=args.rate,
                                  prompt_len=args.prompt_len,
                                  gen_len=args.gen, seed=args.seed + 1)
    elif args.traffic == "replay" and args.trace:
        requests = load_trace(args.trace, cfg.vocab, seed=args.seed + 1)
    elif args.traffic == "replay":
        every = max(int(round(1.0 / args.rate)), 1)
        requests = replay_trace(
            [(i * every, args.prompt_len, args.gen)
             for i in range(args.requests)], cfg.vocab, seed=args.seed + 1)
    else:
        requests = poisson_trace(
            args.requests, args.rate, cfg.vocab,
            prompt_len=args.prompt_len, gen_len=args.gen,
            seed=args.seed + 1)

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    sess = ServingSession(
        cfg, serve_cfg, seed=args.seed, device=args.device,
        telemetry=telemetry if telemetry.enabled else None,
        replication=replication if replication.enabled else None)
    report = sess.run(requests)
    print(f"arch={cfg.name} device={sess.device} "
          f"slots={serve_cfg.max_batch} max_seq={serve_cfg.max_seq} "
          f"kv_budget={serve_cfg.budget_tokens} traffic={args.traffic}")
    print(report.summary())
    if sess.recorder is not None and telemetry.trace_path:
        print(f"recorded {len(sess.recorder)}-step load trace -> "
              f"{telemetry.trace_path}")
    if args.json:
        print(json.dumps(report.to_dict(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
