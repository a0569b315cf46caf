"""Training driver on one device (twin of the single-device branch of
``repro.launch.train``): synthetic learnable data, real MicroEP scheduling
per micro-batch in every MoE layer, AdamW with a warmup-cosine schedule.
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

Runs on the CUDA device unless ``--device cpu`` is given; f32 weights,
random from ``--seed``, drawn on the device.  ``--remat`` rematerialises
every block in the backward (off by default, as the reference's
single-device ``RuntimeConfig(remat=False)``; the reference's single-device
branch drops the flag, this driver honours it).  ``--ckpt-dir`` saves the
trained model's reference tree (``decoder.reference_tree``) at the end in
the reference's checkpoint files, with {"arch": the config's name}.

Telemetry and replication (MoE configs), as the reference's single-device
branch runs them: ``--telemetry-record`` / ``--trace-out`` record each
step's per-expert loads (summed over layers and micro-batches, one readback
a step) into a load trace, saved at the end; ``--prewarm`` fits the
``--predictor`` on the history and, once it holds ``min_history`` steps,
writes ``ReplacementPlanner.warm_start_x(solver="jacobi")`` into every MoE
layer's solver state before the next step; ``--replication`` runs the
replica-topology controller in shadow mode on the one-device placement
(it plans and prices, nothing migrates).  The mesh and multi-host flags of
the reference belong to paths not ported yet, and are refused with an
error.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..core.placement import vanilla_placement
from ..data.synthetic import SyntheticLM
from ..engine import ReplicationConfig, TelemetryConfig
from ..models import decoder as dec
from ..optim.adamw import AdamWConfig
from ..optim.schedule import warmup_cosine
from ..replication import TopologyController
from ..telemetry import (LoadTraceRecorder, ReplacementPlanner,
                         predictor_from_config, prewarm_solver_states)
from ..train.loop import init_train_state, make_train_step
from ..train.metrics import MetricLogger


def _refuse_unported(ap: argparse.ArgumentParser, args) -> None:
    if args.data_axis > 0 or args.model_axis != 1 or args.production_mesh:
        ap.error("--data-axis/--model-axis/--production-mesh: training on a "
                 "mesh of GPUs is not ported yet (ROADMAP.md, Queue 1)")
    if args.num_hosts != 1 or args.coordinator or args.host_id:
        ap.error("--coordinator/--num-hosts/--host-id: multi-host training "
                 "is not ported yet (ROADMAP.md, Queue 1)")


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
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="rematerialise every block in the backward")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the trained parameters here at the end")
    g = ap.add_argument_group("not ported yet (refused)")
    g.add_argument("--data-axis", type=int, default=0)
    g.add_argument("--model-axis", type=int, default=1)
    g.add_argument("--production-mesh", action="store_true")
    g.add_argument("--coordinator", default=None)
    g.add_argument("--num-hosts", type=int, default=1)
    g.add_argument("--host-id", type=int, default=0)
    TelemetryConfig.add_cli_args(ap)
    ReplicationConfig.add_cli_args(ap)
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
    telemetry = TelemetryConfig.from_cli_args(args)
    replication = ReplicationConfig.from_cli_args(args)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.etp is not None:
        cfg = dataclasses.replace(cfg, etp=args.etp)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    # telemetry needs the per-step expert-load vector out of the step;
    # dense and RWKV-6 decoders have nothing to record
    want_load = cfg.moe and (telemetry.record or telemetry.prewarm
                             or telemetry.trace_path is not None
                             or replication.enabled)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    opt_cfg = AdamWConfig(lr=args.lr)
    ts = init_train_state(cfg, seed=args.seed, device=args.device)
    step = make_train_step(
        cfg, opt_cfg=opt_cfg, n_micro=args.n_micro, device=args.device,
        lr_fn=lambda s: warmup_cosine(s, args.lr, warmup=20,
                                      total=args.steps), remat=args.remat,
        with_expert_load=want_load)
    recorder = planner = controller = None
    if want_load:
        # shadow mode: the degenerate one-device placement of E·etp experts
        placement = vanilla_placement(1, 1, cfg.num_experts * max(cfg.etp, 1))
        recorder = LoadTraceRecorder(
            source="train", meta={"arch": cfg.name, "seed": int(args.seed)})
    if want_load and telemetry.prewarm:
        planner = ReplacementPlanner(
            placement, predictor=predictor_from_config(telemetry),
            check_every=10 ** 9,        # plan never; forecast every step
            horizon=telemetry.horizon, seed=args.seed)
    if want_load and replication.enabled:
        controller = TopologyController(
            placement, 3 * cfg.d_model * max(cfg.moe_d_ff, 1) * 4,
            migration_gate=replication.migration_gate,
            predictor=predictor_from_config(telemetry),
            check_every=replication.check_every,
            threshold=replication.threshold,
            improve_margin=replication.improve_margin,
            mc_samples=replication.mc_samples,
            horizon=telemetry.horizon, seed=args.seed)
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
                if planner is not None:
                    planner.observe(eload)
                    if planner.history_size >= planner.min_history:
                        ts = ts._replace(solver=prewarm_solver_states(
                            ts.solver,
                            planner.warm_start_x(solver="jacobi")))
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


if __name__ == "__main__":
    raise SystemExit(main())
