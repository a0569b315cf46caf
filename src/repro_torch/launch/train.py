"""Training launcher (twin of ``repro.launch.train``): synthetic learnable
data, real MicroEP scheduling per micro-batch in every MoE layer, AdamW
with a warmup-cosine schedule, on one device or on a (data × model) group
of ranks.
Dense and MoE global-attention decoders, MoE with any expert tensor
parallelism (``--etp``), and RWKV-6 decoders (K3 forward, K3b backward).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --device cpu --steps 4 --batch 4 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --device cpu --steps 4 --batch 4 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch paper-mixtral-16x2b --smoke --etp 2 --device cpu --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --smoke --device cpu --steps 4 --batch 4 --seq 16 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --steps 20 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --layers 8 --batch 8 --seq 512 --steps 4 [--remat]

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --device cpu --steps 12 --batch 4 --seq 16 \\
      --telemetry-record --trace-out /tmp/load.npz --prewarm --replication
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --device cpu --data-axis 2 --model-axis 2 --backend gloo \\
      --steps 4 --batch 8 --seq 16 [--telemetry-record --prewarm \\
      --replication --replication-check-every 2 --migration-gate 0]

Runs on the CUDA device unless ``--device cpu`` is given; f32 weights,
random from ``--seed``, drawn on the device.  ``--remat`` rematerialises
every block in the backward (off by default, as the reference's
``RuntimeConfig(remat=False)`` for training).  The engine flags are
``RuntimeConfig``'s (``--placement``, ``--mode``, ``--capacity-factor``,
``--pipeline-stages``, ``--chunk-comm``, ``--memory``, ...); they steer the
group's MoE layers, and one device refuses them (apart from ``--remat``).
``--ckpt-dir`` saves the trained model's reference tree
(``decoder.reference_tree``) at the end in the reference's checkpoint
files, with {"arch": the config's name}.

Telemetry and replication (MoE configs), as the reference's single-device
branch runs them: ``--telemetry-record`` / ``--trace-out`` record each
step's per-expert loads (summed over layers and micro-batches, one readback
a step) into a load trace, saved at the end; ``--prewarm`` fits the
``--predictor`` on the history and, once it holds ``min_history`` steps,
writes ``ReplacementPlanner.warm_start_x(solver="jacobi")`` into every MoE
layer's solver state before the next step; ``--replication`` runs the
replica-topology controller: in shadow mode on the one-device placement
(it plans and prices, nothing migrates), and on a group on the group's
placement, where a fired topology rebuilds the runtime and the step, the
solver restarts and the working slots are refilled from the canonical
experts (a table of another slot count a rank is refused).

``--data-axis D --model-axis M`` trains on a group of D × M ranks
(``launch.runtime``): this host spawns them (``launch.mesh.spawn_group``),
or, with ``--coordinator HOST:PORT --num-hosts D·M --host-id i``, this
process is rank i.  ``--backend`` picks torch.distributed's backend:
``nccl`` needs a card for each rank of a host, ``gloo`` runs on the CPU or
lets the ranks share cards.  Every rank draws its share of the same seeded
model and reads the same data stream; rank 0 logs.  ``--report DIR``
writes each rank's JSON record there (losses, kernel launches, peak
memory, a digest of its canonical experts after every step; with the
telemetry flags the trace rows, with ``--replication`` the controller's
decisions and migrations).  ``--production-mesh`` (256 chips) is
refused.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..core.placement import vanilla_placement
from ..data.synthetic import SyntheticLM
from ..engine import ReplicationConfig, RuntimeConfig, TelemetryConfig
from ..models import decoder as dec
from ..optim.adamw import AdamWConfig
from ..optim.schedule import warmup_cosine
from ..replication import TopologyController
from ..telemetry import (LoadTraceRecorder, ReplacementPlanner,
                         predictor_from_config, prewarm_solver_states)
from ..train.loop import init_train_state, make_train_step
from ..train.metrics import MetricLogger
from . import mesh as M
from . import runtime as R
from .check_train import count_plain_calls


def _check_args(ap: argparse.ArgumentParser, args) -> None:
    if args.production_mesh:
        ap.error("--production-mesh: the reference's 256-chip mesh is not "
                 "ported yet (ROADMAP.md, Queue 1)")
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
        engine = M.engine_flags_set(args, keep=("remat", "dtype"))
        if engine:
            ap.error(f"{', '.join(engine)} need --data-axis: the engine "
                     f"flags steer a group's MoE layers, and one device "
                     f"runs the fixed one-device group (capacity factor 2, "
                     f"no pipeline, no MemFine)")
    if args.dtype != "float32":
        ap.error(f"--dtype {args.dtype}: training runs in float32 only (K1b "
                 f"takes float32)")


def _want_load(cfg, telemetry, replication) -> bool:
    """Whether the step reads its expert loads back: telemetry and
    replication need them; dense and RWKV-6 decoders have none."""
    return bool(cfg.moe) and (telemetry.record or telemetry.prewarm
                              or telemetry.trace_path is not None
                              or replication.enabled)


def _load_hooks(cfg, placement, telemetry, replication, seed: int,
                engine=None) -> tuple:
    """(recorder, planner, controller) on ``placement`` (None: none of
    them): the load-trace recorder, the pre-warm's forecast planner with
    ``--prewarm`` and the replica-topology controller with
    ``--replication``, weighted by ``engine``'s profiles on a group."""
    if placement is None:
        return None, None, None
    weights = None if engine is None else engine.weights
    budgets = None if engine is None else engine.slot_budgets
    recorder = LoadTraceRecorder(source="train",
                                 meta={"arch": cfg.name, "seed": int(seed)})
    planner = controller = None
    if telemetry.prewarm:
        planner = ReplacementPlanner(
            placement, predictor=predictor_from_config(telemetry),
            check_every=10 ** 9,        # plan never; forecast every step
            horizon=telemetry.horizon, seed=seed, weights=weights,
            slot_budgets=budgets)
    if replication.enabled:
        controller = TopologyController(
            placement, 3 * cfg.d_model * max(cfg.moe_d_ff, 1) * 4,
            migration_gate=replication.migration_gate,
            predictor=predictor_from_config(telemetry),
            check_every=replication.check_every,
            threshold=replication.threshold,
            improve_margin=replication.improve_margin,
            mc_samples=replication.mc_samples,
            horizon=telemetry.horizon, seed=seed, weights=weights,
            slot_budgets=budgets)
    return recorder, planner, controller


def _prewarm(planner, eload: np.ndarray, ts):
    """Feed the pre-warm's planner one step's loads; once its history holds
    ``min_history`` steps, write ``warm_start_x(solver="jacobi")`` into
    every MoE layer's solver state -> the train state."""
    if planner is None:
        return ts
    planner.observe(eload)
    if planner.history_size < planner.min_history:
        return ts
    return ts._replace(solver=prewarm_solver_states(
        ts.solver, planner.warm_start_x(solver="jacobi")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--etp", type=int, default=None,
                    help="expert tensor parallelism (default the config's; "
                         "--smoke sets 1)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the trained parameters here at the end (one "
                         "device)")
    ap.add_argument("--report", default=None, metavar="DIR",
                    help="on a group: write each rank's JSON record here")
    ap.add_argument("--production-mesh", action="store_true",
                    help="refused: the reference's 256-chip mesh")
    RuntimeConfig.add_cli_args(ap)
    M.add_distributed_cli_args(ap)
    TelemetryConfig.add_cli_args(ap)
    ReplicationConfig.add_cli_args(ap)
    args = ap.parse_args(argv)
    telemetry = TelemetryConfig.from_cli_args(args)
    replication = ReplicationConfig.from_cli_args(args)
    _check_args(ap, args)
    run_cfg = RuntimeConfig.from_cli_args(args)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.etp is not None:
        cfg = dataclasses.replace(cfg, etp=args.etp)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.data_axis > 0:
        return _train_group(args, cfg, run_cfg, telemetry, replication)
    want_load = _want_load(cfg, telemetry, replication)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    opt_cfg = AdamWConfig(lr=args.lr)
    ts = init_train_state(cfg, seed=args.seed, device=args.device)
    step = make_train_step(
        cfg, opt_cfg=opt_cfg, n_micro=args.n_micro, device=args.device,
        lr_fn=lambda s: warmup_cosine(s, args.lr, warmup=20,
                                      total=args.steps), remat=args.remat,
        with_expert_load=want_load)
    # shadow mode: the degenerate one-device placement of E·etp experts
    recorder, planner, controller = _load_hooks(
        cfg, vanilla_placement(1, 1, cfg.num_experts * max(cfg.etp, 1))
        if want_load else None, telemetry, replication, args.seed)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       noise=0.05, n_maps=4, seed=args.seed + 1)
    with MetricLogger(csv_path=args.csv, print_every=10) as logger:
        for i, batch in zip(range(args.steps), data):
            ts, m = step(ts, batch)
            if want_load:
                eload = m.pop("expert_load").cpu().numpy().astype(np.float64)
                recorder.record(i, eload)
                if controller is not None:
                    controller.observe(eload)   # shadow: nothing to migrate
                ts = _prewarm(planner, eload, ts)
            logger.log(i, m)
    if controller is not None:
        print(f"replication (shadow mode, one device): "
              f"{len(controller.decisions)} checks, "
              f"{controller.replacements} topology migrations, "
              f"{controller.moved_slots} slots moved "
              f"({controller.migrated_bytes} B)")
    if recorder is not None and telemetry.trace_path:
        recorder.save(telemetry.trace_path)
        print(f"recorded {len(recorder)}-step load trace -> "
              f"{telemetry.trace_path}")
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps,
                               dec.reference_tree(ts.model),
                               {"arch": cfg.name})
        print("saved", path)
    first = logger.history[0]["loss"]
    last = logger.history[-1]["loss"]
    print(f"arch={cfg.name} device={ts.model.device} loss {first:.4f} -> "
          f"{last:.4f} ({'improved' if last < first else 'NO IMPROVEMENT'})")
    return 0


def _digest(tensors) -> list:
    """Each f32 tensor's bit patterns summed as int64: equal tensors give
    equal digests."""
    return [int(t.contiguous().view(torch.int32).sum(dtype=torch.int64))
            for t in tensors]


def _group_rank(mi, device, args, cfg, run_cfg, telemetry=None,
                replication=None) -> dict:
    """One rank's training loop on the group.  With telemetry or
    replication every rank records the group's loads (the same on every
    rank), pre-warms its solver states and runs the topology controller on
    the group's placement; a fired topology is migrated to: the runtime is
    rebuilt around it with a new step, the solver restarts, and the
    working slots are refilled from the canonical experts at the next
    step's start.  The canonical master and the Adam moments carry over."""
    telemetry = telemetry or TelemetryConfig()
    replication = replication or ReplicationConfig()
    from ..kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                          grouped_ffn_flat_cuda)
    from ..kernels.sched import schedule_cuda
    from ..moe.comm import gather_counts
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    if device.type == "cpu":
        torch.set_num_threads(1)
    want_load = _want_load(cfg, telemetry, replication)
    dr = R.build_runtime(cfg, mi, run_cfg, device=device)
    ts = dr.init_train_state(seed=args.seed)

    def make_step(dr):
        return R.make_train_fn(
            dr, n_micro=args.n_micro, opt_cfg=AdamWConfig(lr=args.lr),
            lr_fn=lambda s: warmup_cosine(s, args.lr, warmup=20,
                                          total=args.steps),
            with_expert_load=want_load)

    step = make_step(dr)
    recorder, planner, controller = _load_hooks(
        cfg, dr.placement if want_load else None, telemetry, replication,
        args.seed, engine=dr.engine)
    migrations = []
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       noise=0.05, n_maps=4, seed=args.seed + 1)
    kernels = (("K1", grouped_ffn_flat_cuda), ("K1b", grouped_ffn_flat_bwd_cuda),
               ("K4", schedule_cuda))
    for _, fn in kernels:
        fn.launches = 0                 # just before the main path
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    record = {"rank": mi.index, "row": mi.row, "col": mi.col, "steps": []}
    logger = (MetricLogger(csv_path=args.csv, print_every=10)
              if mi.index == 0 else contextlib.nullcontext())
    with logger, count_plain_calls() as plain:
        for i, batch in zip(range(args.steps), data):
            t0 = time.perf_counter()
            ts, m = step(ts, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            digest = _digest(t for _, t in sorted((ts.canonical or {}).items()))
            # the rows of a column must hold the same canonical experts
            same_rows = True
            if mi.data > 1 and digest:
                every = gather_counts(torch.tensor(digest, device=device),
                                      mi.col_pg)
                same_rows = bool((every == every[:, :1]).all())
            if want_load:
                eload = m.pop("expert_load").cpu().numpy().astype(np.float64)
                recorder.record(i, eload)
                table = None if controller is None else \
                    controller.observe(eload)
                if table is not None:
                    t1 = time.perf_counter()
                    dr = _migrate_topology(dr, cfg, mi, run_cfg, table,
                                           device)
                    step = make_step(dr)
                    ts = ts._replace(solver=dr.init_solver())
                    if planner is not None:
                        planner.placement = dr.placement
                    migrations.append({"step": i,
                                       "table": table.table.tolist(),
                                       "build_s": time.perf_counter() - t1})
                ts = _prewarm(planner, eload, ts)
            if mi.index == 0:
                logger.log(i, m)
            record["steps"].append({
                "wall_s": wall, "same_rows": same_rows, "digest": digest,
                **{k: float(v) for k, v in m.items()}})
    record["launches"] = {name: fn.launches for name, fn in kernels}
    record["plain"] = dict(plain)
    if recorder is not None:
        record["trace"] = recorder.history().tolist()
        if telemetry.trace_path and mi.index == 0:
            recorder.save(telemetry.trace_path)
    if controller is not None:
        record["replication"] = {
            "decisions": controller.decisions, "migrations": migrations,
            "replacements": controller.replacements,
            "moved_slots": controller.moved_slots,
            "migrated_bytes": controller.migrated_bytes}
    if device.type == "cuda":
        record["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    if args.report:
        os.makedirs(args.report, exist_ok=True)
        with open(os.path.join(args.report, f"rank{mi.index}.json"),
                  "w") as f:
            json.dump(record, f)
    if mi.index == 0:
        first, last = (record["steps"][0]["loss"],
                       record["steps"][-1]["loss"])
        if controller is not None:
            print(f"replication on the group: {len(controller.decisions)} "
                  f"checks, {controller.replacements} topology migrations "
                  f"(steps {[m['step'] for m in migrations]}), "
                  f"{controller.moved_slots} slots moved "
                  f"({controller.migrated_bytes} B)")
        if recorder is not None and telemetry.trace_path:
            print(f"recorded {len(recorder)}-step load trace -> "
                  f"{telemetry.trace_path}")
        print(f"arch={cfg.name} group={mi.data}x{mi.model} device={device} "
              f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if not all(st["same_rows"] for st in record["steps"]):
        raise RuntimeError(f"rank {mi.index}: the rows of column {mi.col} "
                           f"hold different canonical experts")
    return record


def _migrate_topology(dr, cfg, mi, run_cfg, table, device):
    """The runtime around a fired topology; a table that changes this
    rank's slot count is refused (the working slots and their optimizer
    state keep their shape)."""
    new = R.build_runtime(cfg, mi, run_cfg, placement_table=table,
                          device=device)
    if new.placement.slots != dr.placement.slots:
        raise RuntimeError(
            f"the fired topology gives each rank {new.placement.slots} "
            f"slots, the running placement {dr.placement.slots}: training "
            f"migrates only between tables of one slot count")
    return new


def _train_group(args, cfg, run_cfg, telemetry, replication) -> int:
    backend = args.backend or M.default_backend(args.device)
    world = args.data_axis * args.model_axis
    rest = (args, cfg, run_cfg, telemetry, replication)
    if args.num_hosts == 1:
        M.spawn_group(_group_rank, rest, args.data_axis, args.model_axis,
                      backend=backend, device=args.device)
        return 0
    mi, dev = M.init_rank(args.host_id, world, f"tcp://{args.coordinator}",
                          backend, args.device, args.data_axis,
                          args.model_axis, local_rank=0, local_ranks=1)
    try:
        _group_rank(mi, dev, *rest)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
