"""Where the device time of the full-sequence forward goes, from one
``torch.profiler`` run on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_forward [--out DIR]
      [--arch NAME] [--layers N]

Builds ``--arch`` (default rwkv6-7b; any config the forward runs: RWKV-6,
or global attention, dense or MoE) at full width, with its depth cut to
``--layers`` if given, with f32 weights drawn on the card from ``SEED``
(TF32 off), runs one forward of ``BATCH`` x ``SEQ`` tokens through
``make_forward_fn`` as a warm-up, then profiles one more (serving prefill,
``last_only``).  ``chip_smoke.py`` drives rwkv6-7b's forward at the same
``BATCH`` and ``SEQ``.  Prints the device time of K3 (RWKV-6), K1 and K4
(MoE), the matrix products and the rest, and the device's idle share:
the part of the forward's wall window (host clock, ending in a
synchronisation) in which no kernel or copy ran.  Writes the per-kernel
table and the same summary as JSON under ``--out`` (default
``build/profile/`` of the checkout).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..configs import get_config
from ..models import decoder as dec
from .runtime import make_forward_fn

ROOT = pathlib.Path(__file__).resolve().parents[3]
ARCH, BATCH, SEQ, SEED = "rwkv6-7b", 4, 2048, 0
WINDOW = "profiled_forward"
MATMUL_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "splitk")


PARTS = (("K3 (wkv6)", ("wkv6_kernel",)),
         ("K1 (grouped FFN)", ("ffn_up_kernel", "ffn_down_kernel")),
         ("K4 (scheduler)", ("microep_sched_kernel",)),
         ("matrix products", MATMUL_MARKS))


def part_of(kernel: str) -> str:
    """The part of the forward a device kernel belongs to, by its name."""
    low = kernel.lower()
    for part, marks in PARTS:
        if any(m.lower() in low for m in marks):
            return part
    return "rest"


def _busy_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def profile_device(run, part_of):
    """Profile one call of ``run``, which ends in a device synchronisation.
    -> (summary: the call's wall window, device and busy time in ms, the
    idle share, device ms by ``part_of`` each kernel's name and the number
    of device events; {kernel name: (calls, device us)}; the device
    events)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run()
    events = prof.events()
    window = [e for e in events
              if e.name == WINDOW and e.device_type == DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name != WINDOW
               and not getattr(e, "is_user_annotation", False)]
    if len(window) != 1 or not kernels:
        raise RuntimeError(f"the profiler recorded {len(kernels)} device "
                           f"events and {len(window)} windows")
    lo, hi = window[0].time_range.start, window[0].time_range.end
    by_part: dict = {}
    by_kernel: dict = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_part[part_of(e.name)] = by_part.get(part_of(e.name), 0.0) + us
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + us)
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels], lo, hi)
    summary = {
        "window_ms": (hi - lo) / 1e3,
        "device_ms": sum(by_part.values()) / 1e3,
        "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / (hi - lo),
        "parts_ms": {k: v / 1e3 for k, v in sorted(by_part.items())},
        "kernel_launches": len(kernels),
    }
    return summary, by_kernel, kernels


def report(summary: dict, by_kernel: dict, part_of, out: str,
           stem: str) -> list:
    """Print the device time by part; write the per-kernel table and the
    summary under ``out`` as ``stem``.txt and ``stem``.json.  -> the
    kernels by total device time."""
    for part, ms in summary["parts_ms"].items():
        print(f"  {part:20s} {ms:10.3f} ms  "
              f"{ms / summary['device_ms']:7.2%} of device time")
    path = pathlib.Path(out)
    path.mkdir(parents=True, exist_ok=True)
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    with open(path / f"{stem}.txt", "w") as fh:
        fh.write(f"{summary['card']}\n{json.dumps(summary)}\n")
        fh.write("device ms  calls  part                  kernel\n")
        for name, (n, us) in rows:
            fh.write(f"{us / 1e3:9.3f}  {n:5d}  {part_of(name):20s}  "
                     f"{name[:160]}\n")
    (path / f"{stem}.json").write_text(json.dumps(summary, indent=1))
    print(f"per-kernel table: {path / f'{stem}.txt'}")
    return rows


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)

    device = dec.require_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = dec.init_params(cfg, seed=SEED, device=device)
    g = torch.Generator(device=model.device)
    g.manual_seed(SEED + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, SEQ),
                                     generator=g, device=model.device)}
    fwd = make_forward_fn(model, last_only=True)
    fwd(batch)                                   # warm-up
    torch.cuda.synchronize()

    def run():
        fwd(batch)
        torch.cuda.synchronize()

    split, by_kernel, _ = profile_device(run, part_of)
    summary = {"card": card, "arch": cfg.name, "layers": cfg.num_layers,
               "batch": BATCH, "seq": SEQ, "last_only": True,
               **split}
    print(card)
    print(f"{cfg.name}, {cfg.num_layers} layers, {BATCH} x {SEQ} tokens, "
          f"last_only: "
          f"window {summary['window_ms']:.3f} ms, device time "
          f"{summary['device_ms']:.3f} ms in {summary['kernel_launches']} "
          f"device events, idle share {summary['idle_share']:.4f}")
    report(summary, by_kernel, part_of, args.out, "profile_forward")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
