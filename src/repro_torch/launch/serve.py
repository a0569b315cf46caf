"""Serving entry point (twin of ``repro.launch.serve``), on one device or on
a (data × model) group of ranks, co-located or disaggregated: Poisson or
replay traffic feeds the slot/KV-budget batch manager; one decode step per
tick interleaves prefill and decode and re-runs the MicroEP scheduler in
every MoE layer on the live batch's expert loads (an RWKV-6 decoder carries
each slot's recurrent state through K3s instead; a dense decoder has no MoE
layer and reports no balance).

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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --smoke --device cpu --data-axis 2 --model-axis 2 --backend gloo \
      --max-batch 8 --replacement --repl-check-every 4 --repl-threshold 1.0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --smoke --device cpu --disagg --prefill-slots 4 --decode-slots 4 \
      [--data-axis 2 --model-axis 2 --backend gloo]
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch paper-gpt-32x1.3b --smoke --device cpu --fleet \
      --min-groups 2 --max-groups 3 --scaling-policy queue_depth \
      --scale-check-every 4 --drain-grace-steps 2 --group-profiles 1@4 \
      --resilience --crash-at-steps 12 --straggler-at-steps 2 \
      --straggler-window 6

Runs on the CUDA device unless ``--device cpu`` is given; weights are f32,
random from ``--seed``, drawn on the device.  ``--replacement`` (reactive;
``--forecast-replacement`` for the forecast planner) and ``--replication``
(the replica-topology controller) run the replacement hook: in shadow mode
on one device (it checks and records its decisions, nothing migrates), and
on a group each fired placement is migrated to, the working slots refilled
from the canonical experts.  ``--telemetry-record`` / ``--trace-out``
record each decode step's expert loads; ``--traffic trace --trace FILE``
shapes arrivals from such a load trace, ``--traffic replay --trace
FILE.json`` replays a JSON request trace.

``--data-axis D --model-axis M`` serves on a group of D × M ranks: this
host spawns them (``launch.mesh.spawn_group``), or, with ``--coordinator
HOST:PORT --num-hosts D·M --host-id i``, this process is rank i.
``--backend`` picks torch.distributed's backend (``nccl`` needs a card for
each rank of a host, ``gloo`` runs on the CPU or lets ranks share cards).
The engine flags (``RuntimeConfig``'s: ``--placement``,
``--capacity-factor``, ``--pipeline-stages``, ...) steer the group's MoE
layers, and one device refuses them.  Every rank serves the same requests;
rank 0 prints the report.

``--disagg`` (with ``--prefill-slots``, ``--decode-slots``,
``--handoff-depth`` and, on a group, ``--prefill-profiles`` /
``--decode-profiles``) splits serving into a prefill fleet and a decode
fleet joined by a bounded KV-handoff buffer.

Elastic fleet flags (``--fleet``, ``--scaling-policy``, ``--min-groups`` /
``--max-groups``, ``--slots-per-group``, ``--group-profiles``,
``--scale-check-every``, ``--drain-grace-steps``) let the session admit
and drain device groups on the step clock (the controller's placements run
shadow, the moves priced); resilience flags (``--resilience``,
``--crash-at-steps``, ``--straggler-at-steps``,
``--transfer-fail-at-steps``, ``--max-retries``, ...) arm fault injection
and recovery on the same clock: crashes and stragglers need ``--fleet``,
transfer failures need ``--disagg``, and ``--fleet`` with ``--disagg`` is
refused, as the reference refuses them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..configs import get_config
from ..engine import (DisaggConfig, FleetConfig, ReplicationConfig,
                      ResilienceConfig, RuntimeConfig, ServeConfig,
                      TelemetryConfig)
from ..serve import (ServingSession, load_trace, poisson_trace, replay_trace,
                     trace_requests)
from . import mesh as M


def _parser() -> argparse.ArgumentParser:
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
    RuntimeConfig.add_cli_args(ap)
    M.add_distributed_cli_args(ap)
    ServeConfig.add_cli_args(ap)
    TelemetryConfig.add_cli_args(ap)
    ReplicationConfig.add_cli_args(ap)
    DisaggConfig.add_cli_args(ap)
    FleetConfig.add_cli_args(ap)
    ResilienceConfig.add_cli_args(ap)
    return ap


def _check_args(ap: argparse.ArgumentParser, args, serve_cfg, telemetry,
                disagg, fleet, resilience) -> None:
    if fleet.enabled and disagg.enabled:
        ap.error("--fleet and --disagg cannot be combined")
    if resilience.enabled and not (fleet.enabled or disagg.enabled):
        ap.error("--resilience needs --fleet (group crashes/stragglers) "
                 "or --disagg (transfer failures)")
    if resilience.enabled and resilience.has_group_faults \
            and not fleet.enabled:
        ap.error("crash/straggler faults need --fleet")
    if resilience.enabled and resilience.has_transfer_faults \
            and not disagg.enabled:
        ap.error("transfer faults need --disagg")
    if telemetry.forecast_replacement and not serve_cfg.replacement:
        ap.error("--forecast-replacement selects the trigger policy of the "
                 "replacement hook; enable the hook with --replacement")
    err = M.check_distributed_args(args)
    if err:
        ap.error(err)
    if args.data_axis == 0:
        if args.model_axis != 1 or args.num_hosts != 1:
            ap.error("--model-axis/--num-hosts need --data-axis: a group of "
                     "ranks has data-axis rows")
        if args.backend is not None:
            ap.error("--backend needs --data-axis: one device runs no "
                     "collective")
        engine = M.engine_flags_set(args)
        if engine:
            ap.error(f"{', '.join(engine)} need --data-axis: the engine "
                     f"flags steer a group's MoE layers, and one device "
                     f"runs the fixed one-device group")
        if disagg.prefill_profiles is not None or \
                disagg.decode_profiles is not None:
            ap.error("--prefill-profiles/--decode-profiles need "
                     "--data-axis: they weigh a group's ranks")
    elif args.dtype != "float32" or args.remat:
        ap.error("serving runs in float32 and has no backward: --dtype "
                 "bfloat16 and --remat are refused")


def _requests(ap, args, cfg):
    if args.traffic == "trace":
        if not args.trace:
            ap.error("--traffic trace needs --trace LOADTRACE.npz")
        return trace_requests(args.trace, cfg.vocab, rate=args.rate,
                              prompt_len=args.prompt_len, gen_len=args.gen,
                              seed=args.seed + 1)
    if args.traffic == "replay" and args.trace:
        return load_trace(args.trace, cfg.vocab, seed=args.seed + 1)
    if args.traffic == "replay":
        every = max(int(round(1.0 / args.rate)), 1)
        return replay_trace([(i * every, args.prompt_len, args.gen)
                             for i in range(args.requests)], cfg.vocab,
                            seed=args.seed + 1)
    return poisson_trace(args.requests, args.rate, cfg.vocab,
                         prompt_len=args.prompt_len, gen_len=args.gen,
                         seed=args.seed + 1)


def _serve(mi, device, args, cfg, serve_cfg, run_cfg, telemetry,
           replication, disagg, fleet, resilience, requests) -> dict:
    """Build the session (one device when ``mi`` is None, else this rank's
    of the group), serve ``requests`` and print on rank 0 -> the report's
    dict."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    if mi is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    sess = ServingSession(
        cfg, serve_cfg, run_cfg=run_cfg if mi is not None else None,
        mesh=mi, seed=args.seed, device=device,
        telemetry=telemetry if telemetry.enabled else None,
        replication=replication if replication.enabled else None,
        disagg=disagg if disagg.enabled else None,
        fleet=fleet if fleet.enabled else None,
        resilience=resilience if resilience.enabled else None)
    report = sess.run(requests)
    if mi is None or mi.index == 0:
        where = ("" if mi is None else
                 f" group={mi.data}x{mi.model} ({run_cfg.placement.strategy})")
        if disagg.enabled:
            print(f"arch={cfg.name} device={sess.device}{where} disagg: "
                  f"prefill={disagg.prefill_slots} "
                  f"decode={disagg.decode_slots} "
                  f"handoff_depth={disagg.handoff_depth} "
                  f"max_seq={serve_cfg.max_seq} traffic={args.traffic}")
        elif fleet.enabled:
            print(f"arch={cfg.name} device={sess.device}{where} fleet: "
                  f"groups in [{fleet.min_groups}, {fleet.max_groups}] x "
                  f"{fleet.slots_per_group} slots, "
                  f"policy={fleet.scaling_policy} "
                  f"max_seq={serve_cfg.max_seq} traffic={args.traffic}")
        else:
            print(f"arch={cfg.name} device={sess.device}{where} "
                  f"slots={serve_cfg.max_batch} max_seq={serve_cfg.max_seq} "
                  f"kv_budget={serve_cfg.budget_tokens} "
                  f"traffic={args.traffic}")
        print(report.summary())
        for m in sess.migration_log:
            print(f"migration at step {m['step']}"
                  + (f" ({m['fleet']} fleet)" if m["fleet"] else "")
                  + f": {m['wall_s'] * 1e3:.1f} ms of suspension")
        if sess.recorder is not None and telemetry.trace_path:
            print(f"recorded {len(sess.recorder)}-step load trace -> "
                  f"{telemetry.trace_path}")
        if args.json:
            print(json.dumps(report.to_dict(), indent=1))
    return report.to_dict()


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    serve_cfg = ServeConfig.from_cli_args(args)
    telemetry = TelemetryConfig.from_cli_args(args)
    replication = ReplicationConfig.from_cli_args(args)
    disagg = DisaggConfig.from_cli_args(args)
    fleet = FleetConfig.from_cli_args(args)
    resilience = ResilienceConfig.from_cli_args(args)
    _check_args(ap, args, serve_cfg, telemetry, disagg, fleet, resilience)
    run_cfg = RuntimeConfig.from_cli_args(args)

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
    requests = _requests(ap, args, cfg)
    rest = (args, cfg, serve_cfg, run_cfg, telemetry, replication, disagg,
            fleet, resilience, requests)
    if args.data_axis == 0:
        _serve(None, args.device, *rest)
        return 0
    backend = args.backend or M.default_backend(args.device)
    if args.num_hosts == 1:
        M.spawn_group(_serve, rest, args.data_axis, args.model_axis,
                      backend=backend, device=args.device)
        return 0
    mi, dev = M.init_rank(args.host_id, args.data_axis * args.model_axis,
                          f"tcp://{args.coordinator}", backend, args.device,
                          args.data_axis, args.model_axis, local_rank=0,
                          local_ranks=1)
    try:
        _serve(mi, dev, *rest)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
