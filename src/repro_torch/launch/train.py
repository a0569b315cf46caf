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

Runs on the CUDA device unless ``--device cpu`` is given; f32 weights,
random from ``--seed``, drawn on the device.  ``--remat`` rematerialises
every block in the backward (off by default, as the reference's
single-device ``RuntimeConfig(remat=False)``; the reference's single-device
branch drops the flag, this driver honours it).  ``--ckpt-dir`` saves the
trained model's reference tree (``decoder.reference_tree``) at the end in
the reference's checkpoint files, with {"arch": the config's name}.  The
mesh, multi-host, telemetry, replication and pre-warm flags of the
reference belong to paths not ported yet, and are refused with an error.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..checkpoint import save_checkpoint
from ..configs import get_config
from ..data.synthetic import SyntheticLM
from ..models import decoder as dec
from ..optim.adamw import AdamWConfig
from ..optim.schedule import warmup_cosine
from ..train.loop import init_train_state, make_train_step
from ..train.metrics import MetricLogger


def _refuse_unported(ap: argparse.ArgumentParser, args) -> None:
    if args.data_axis > 0 or args.model_axis != 1 or args.production_mesh:
        ap.error("--data-axis/--model-axis/--production-mesh: training on a "
                 "mesh of GPUs is not ported yet (ROADMAP.md, Queue 1)")
    if args.num_hosts != 1 or args.coordinator or args.host_id:
        ap.error("--coordinator/--num-hosts/--host-id: multi-host training "
                 "is not ported yet (ROADMAP.md, Queue 1)")
    if args.telemetry_record or args.trace_out or args.prewarm \
            or args.replication:
        ap.error("--telemetry-record/--trace-out/--prewarm/--replication: "
                 "telemetry and replication in training are not ported yet "
                 "(ROADMAP.md, Queue 1)")


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
    g.add_argument("--telemetry-record", action="store_true")
    g.add_argument("--trace-out", default=None)
    g.add_argument("--prewarm", action="store_true")
    g.add_argument("--replication", action="store_true")
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.etp is not None:
        cfg = dataclasses.replace(cfg, etp=args.etp)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    opt_cfg = AdamWConfig(lr=args.lr)
    ts = init_train_state(cfg, seed=args.seed, device=args.device)
    step = make_train_step(
        cfg, opt_cfg=opt_cfg, n_micro=args.n_micro, device=args.device,
        lr_fn=lambda s: warmup_cosine(s, args.lr, warmup=20,
                                      total=args.steps), remat=args.remat)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       noise=0.05, n_maps=4, seed=args.seed + 1)
    with MetricLogger(csv_path=args.csv, print_every=10) as logger:
        for i, batch in zip(range(args.steps), data):
            ts, m = step(ts, batch)
            logger.log(i, m)
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
