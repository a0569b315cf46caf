"""Load-trace tooling CLI: record, inspect, evaluate predictors
(TELEMETRY.md; twin of ``repro.launch.trace``, with ``--device`` in place of
the reference's runtime flags).

  # record a trace from a serving run (Poisson traffic)
  PYTHONPATH=src python -m repro_torch.launch.trace record \
      --arch paper-gpt-32x1.3b --smoke --device cpu --source serve \
      --requests 8 --out trace.npz

  # record from a short training run instead
  PYTHONPATH=src python -m repro_torch.launch.trace record \
      --arch paper-gpt-32x1.3b --smoke --device cpu --source train \
      --steps 16 --out trace.jsonl

  # schema/meta + per-step load statistics
  PYTHONPATH=src python -m repro_torch.launch.trace inspect trace.npz

  # walk-forward accuracy of every registered predictor
  PYTHONPATH=src python -m repro_torch.launch.trace eval-predictors trace.npz

``record`` drives the real loops (the serving session or the train step)
with a :class:`repro_torch.telemetry.LoadTraceRecorder` attached, so a
recorded trace replays the exact expert loads the MicroEP scheduler saw.
It runs on the CUDA device unless ``--device cpu`` is given; the files are
the reference's, and ``repro.launch.trace inspect`` reads them too.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..configs import get_config
from ..engine import ServeConfig, TelemetryConfig
from ..telemetry import (SCHEMA_VERSION, LoadTrace, evaluate_predictor,
                         predictors)


def _record(args) -> int:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if not cfg.moe:
        raise SystemExit(f"--arch {args.arch} is dense: no expert loads "
                         f"to record")
    telemetry = TelemetryConfig(record=True, trace_path=args.out)
    if args.source == "serve":
        from ..serve import ServingSession, poisson_trace
        serve_cfg = ServeConfig(max_batch=4,
                                max_seq=args.prompt_len + args.gen)
        sess = ServingSession(cfg, serve_cfg, seed=args.seed,
                              device=args.device, telemetry=telemetry)
        requests = poisson_trace(args.requests, args.rate, cfg.vocab,
                                 prompt_len=args.prompt_len,
                                 gen_len=args.gen, seed=args.seed + 1)
        sess.run(requests)
        n = len(sess.recorder)
    else:                                   # train
        from ..data.synthetic import SyntheticLM
        from ..telemetry import LoadTraceRecorder
        from ..train.loop import init_train_state, make_train_step
        ts = init_train_state(cfg, seed=args.seed, device=args.device)
        step = make_train_step(cfg, n_micro=args.n_micro, device=args.device,
                               with_expert_load=True)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                           batch=args.batch, noise=0.05, n_maps=4,
                           seed=args.seed + 1)
        rec = LoadTraceRecorder(source="train",
                                meta={"arch": cfg.name,
                                      "seed": int(args.seed)})
        for i, batch in zip(range(args.steps), data):
            ts, m = step(ts, batch)
            rec.record(i, m["expert_load"].cpu().numpy().astype(np.float64))
        rec.save(args.out)
        n = len(rec)
    print(f"recorded {n}-step load trace ({cfg.name}, source="
          f"{args.source}) -> {args.out}")
    return 0


def _inspect(args) -> int:
    tr = LoadTrace.load(args.trace)
    summed = tr.layer_sum()
    skew = tr.skew()
    info = {
        "schema": SCHEMA_VERSION,
        "steps": len(tr),
        "layers": tr.num_layers,
        "experts": tr.num_experts,
        "step_range": ([int(tr.steps[0]), int(tr.steps[-1])]
                       if len(tr) else None),
        "total_load": round(float(summed.sum()), 3),
        "mean_load_per_step": (round(float(summed.sum(1).mean()), 3)
                               if len(tr) else None),
        "skew_max_over_mean": ({
            "min": round(float(skew.min()), 4),
            "mean": round(float(skew.mean()), 4),
            "max": round(float(skew.max()), 4),
        } if len(tr) else None),
        "top_experts": (np.argsort(-summed.sum(0))[:5].tolist()
                        if len(tr) else []),
        "meta": tr.meta,
    }
    if args.json:
        print(json.dumps(info, indent=1))
    else:
        for k, v in info.items():
            print(f"{k}: {v}")
    return 0


def _eval(args) -> int:
    tr = LoadTrace.load(args.trace)
    names = (args.predictors.split(",") if args.predictors
             else list(predictors.names()))
    kwargs = {
        "ema": {"decay": args.ema_decay},
        "window": {"window": args.window},
        "frozen": {"window": args.freeze_window,
                   "threshold": args.freeze_threshold},
    }
    results = [evaluate_predictor(n, tr, horizon=args.horizon,
                                  top_k=args.top_k, **kwargs.get(n, {}))
               for n in names]
    if args.json:
        print(json.dumps(results, indent=1))
    else:
        hit = f"top{args.top_k}_hit_rate"
        for r in results:
            fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
            print(f"{r['predictor']:>8}: rel_l1={fmt(r['rel_l1'])} "
                  f"{hit}={fmt(r[hit])} (n={r['n_evals']}, "
                  f"horizon={r['horizon']})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.trace")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="record a load trace from a run")
    rec.add_argument("--arch", required=True)
    rec.add_argument("--smoke", action="store_true")
    rec.add_argument("--device", default="cuda",
                     help="torch device to run on (default cuda)")
    rec.add_argument("--source", default="serve",
                     choices=["serve", "train"])
    rec.add_argument("--out", required=True,
                     help="trace path (.npz or .jsonl)")
    rec.add_argument("--seed", type=int, default=0)
    rec.add_argument("--requests", type=int, default=8,
                     help="[serve] request count")
    rec.add_argument("--rate", type=float, default=0.25,
                     help="[serve] poisson rate (requests/step)")
    rec.add_argument("--prompt-len", type=int, default=10)
    rec.add_argument("--gen", type=int, default=12)
    rec.add_argument("--steps", type=int, default=16,
                     help="[train] train steps")
    rec.add_argument("--batch", type=int, default=4)
    rec.add_argument("--seq", type=int, default=16)
    rec.add_argument("--n-micro", type=int, default=2)
    rec.set_defaults(fn=_record)

    ins = sub.add_parser("inspect", help="schema, meta and load statistics")
    ins.add_argument("trace")
    ins.add_argument("--json", action="store_true")
    ins.set_defaults(fn=_inspect)

    ev = sub.add_parser("eval-predictors",
                        help="walk-forward predictor accuracy on a trace")
    ev.add_argument("trace")
    ev.add_argument("--predictors", default=None,
                    help="comma-separated registry keys (default: all)")
    ev.add_argument("--horizon", type=int, default=1)
    ev.add_argument("--top-k", type=int, default=2)
    ev.add_argument("--window", type=int, default=8)
    ev.add_argument("--ema-decay", type=float, default=0.9)
    ev.add_argument("--freeze-window", type=int, default=8)
    ev.add_argument("--freeze-threshold", type=float, default=0.05)
    ev.add_argument("--json", action="store_true")
    ev.set_defaults(fn=_eval)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
