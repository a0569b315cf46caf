"""Where the device time of one training step goes, from one
``torch.profiler`` run on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_train [--out DIR]
      [--arch NAME] [--layers N]

Builds ``--arch`` (default olmoe-1b-7b; any config the training step runs:
global attention, dense or MoE of any ``etp``, and RWKV-6, e.g.
``--arch rwkv6-7b --layers 8``) at full width with its depth
cut to ``--layers`` (default ``LAYERS``, as ``chip_smoke.py`` phase 12 does:
f32 master, gradients and two Adam moments take 16 B a parameter; pass 0
for the full depth) with f32 weights drawn on the card from ``SEED``
(TF32 off), takes one step of ``BATCH`` x ``SEQ`` tokens of the synthetic
stream in ``N_MICRO`` micro-batches as a warm-up, then profiles one more.
Prints the device time of K1, K1b, K4, K3 (the RWKV-6 recurrence), K3b
(its backward), the matrix products (cuBLAS), the indexing kernels
(gathers, scatters, index_put), and the rest, and the
device's idle share: the part of the step's wall window (host clock,
ending in a synchronisation) in which no kernel or copy ran, and the
largest kernel's calls one by one.  Writes the per-kernel table and the
summary as JSON under ``--out`` (default ``build/profile/`` of the
checkout).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_config
from ..data.synthetic import SyntheticLM
from ..models import decoder as dec
from ..train.loop import init_train_state, make_train_step
from .profile_forward import (MATMUL_MARKS, ROOT, card_line, profile_device,
                              report)

ARCH, LAYERS, BATCH, SEQ, N_MICRO, SEED = "olmoe-1b-7b", 4, 8, 512, 2, 0
PARTS = (("K1 (grouped FFN)", ("ffn_up_kernel", "ffn_down_kernel")),
         ("K1b (its backward)", ("bwd_hidden", "bwd_dx", "bwd_weights")),
         ("K4 (scheduler)", ("microep_sched_kernel",)),
         ("K3b (wkv backward)", ("wkv6_bwd_kernel",)),
         ("K3 (RWKV-6 wkv)", ("wkv6_kernel", "wkv6_step_kernel")),
         ("matrix products", MATMUL_MARKS),
         ("indexing", ("index", "gather", "scatter")))


def part_of(kernel: str) -> str:
    """The part of the step a device kernel belongs to, by its name."""
    low = kernel.lower()
    for part, marks in PARTS:
        if any(m.lower() in low for m in marks):
            return part
    return "rest"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--layers", type=int, default=LAYERS,
                    help="cut the depth to this many layers (0: full depth)")
    args = ap.parse_args(argv)

    device = dec.require_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    state = {"ts": init_train_state(cfg, seed=SEED, device=device)}
    step = make_train_step(cfg, n_micro=N_MICRO, device=device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH,
                       seed=SEED + 1)

    def run(i: int):
        state["ts"], m = step(state["ts"], data.batch_at(i))
        state["loss"] = float(m["loss"])
        torch.cuda.synchronize()

    run(0)                                       # warm-up
    split, by_kernel, kernels = profile_device(lambda: run(1), part_of)
    summary = {"card": card, "arch": cfg.name, "layers": cfg.num_layers,
               "batch": BATCH, "seq": SEQ, "n_micro": N_MICRO,
               "loss": state["loss"], **split}
    print(card)
    print(f"{cfg.name}, {cfg.num_layers} layers, {BATCH} x {SEQ} tokens in "
          f"{N_MICRO} micro-batches: window {summary['window_ms']:.3f} ms, "
          f"device time {summary['device_ms']:.3f} ms in "
          f"{summary['kernel_launches']} device events, idle share "
          f"{summary['idle_share']:.4f}")
    rows = report(summary, by_kernel, part_of, args.out, "profile_train")
    for name, (n, us) in rows[:12]:
        print(f"  {us / 1e3:9.3f} ms {n:5d}x  {name[:110]}")
    top = rows[0][0]
    calls = [(e.time_range.end - e.time_range.start) / 1e3
             for e in sorted(kernels, key=lambda e: e.time_range.start)
             if e.name == top]
    print(f"the largest kernel's calls in launch order (ms): "
          f"{' '.join(f'{c:.3f}' for c in calls)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
