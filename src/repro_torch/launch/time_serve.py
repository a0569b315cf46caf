"""The served decode step of an MoE decoder at full width and depth, with no
hook on, for this checkout and for other source trees, in turns.

  PYTHONPATH=src python -m repro_torch.launch.time_serve [--against DIR ...]
      [--arch olmoe-1b-7b] [--turns 2] [--runs 3] [--out DIR] [--disagg]

The session is ``chip_smoke.py`` phase 4's: f32 weights drawn on the card
from seed 0, 4 Poisson requests (rate 0.5, 8-token prompts, 8 generated,
seed 1), 4 slots, TF32 off.  Each turn runs one process per tree, this
checkout first and then each ``--against`` tree (a source tree with a
``src/repro_torch``, such as an earlier commit unpacked by ``git archive``
into the git-ignored ``build/``), in the reverse order every second turn:
this, other, other, this.  A process imports ``repro_torch`` from its
tree's ``src``, serves the requests once to build the kernels and warm the
allocator, then ``--runs`` times, and reports each run's wall time a decode
step (the session's ``wall_s / decode_steps``).  The process runs
``WORKER``, which uses only the session API that every tree since the
serving slice has, so an earlier tree needs no copy of this file.  Prints
every run, each tree's mean and median and the card's name and power
limit, and writes the summary as JSON under ``--out``.  Needs a CUDA
device.

``--disagg`` times the two-fleet step instead: the same requests served
disaggregated (4 prefill and 4 decode slots, handoff depth 2), each run's
wall a tick that stepped a fleet.  Every tree then needs
``DisaggConfig`` (``repro_torch.engine``, from the disaggregation slice
on).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
from typing import List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[3]

WORKER = r"""
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.engine import ServeConfig
from repro_torch.models import decoder as dec
from repro_torch.serve import ServingSession, poisson_trace
arch, runs, disagg = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "disagg"
split = {}
if disagg:
    from repro_torch.engine import DisaggConfig
    split["disagg"] = DisaggConfig(enabled=True, prefill_slots=4,
                                   decode_slots=4, handoff_depth=2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = torch.device("cuda", 0)
cfg = get_config(arch)
model = dec.init_params(cfg, seed=0, device=device)
requests = poisson_trace(4, rate=0.5, vocab=cfg.vocab, prompt_len=8,
                         gen_len=8, seed=1)
sess = ServingSession(cfg, ServeConfig(max_batch=4, max_seq=16),
                      device=device, model=model, **split)
sess.run(requests)
ms, steps = [], []
for _ in range(runs):
    r = sess.run(requests)
    ms.append(r.wall_s / r.decode_steps * 1e3)
    steps.append(r.decode_steps)
print("TIME_SERVE " + json.dumps({"ms": ms, "decode_steps": steps}))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def serve_once(tree: pathlib.Path, arch: str, runs: int,
               disagg: bool = False) -> dict:
    """One process serving from ``tree``'s ``repro_torch``."""
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, "-c", WORKER, arch, str(runs),
                          "disagg" if disagg else "colocated"],
                         env=env, capture_output=True, text=True)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("TIME_SERVE ")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"{tree}: rc {out.returncode}\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(lines[-1][len("TIME_SERVE "):])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="*", default=[], type=pathlib.Path)
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--disagg", action="store_true",
                    help="time the disaggregated two-fleet step")
    args = ap.parse_args(argv)
    trees = [ROOT] + [p.resolve() for p in args.against]
    for t in trees:
        if not (t / "src" / "repro_torch").is_dir():
            ap.error(f"{t} holds no src/repro_torch")
    card = card_line()
    print(card)
    per_tree = {str(t): [] for t in trees}
    for k in range(args.turns):
        for t in (trees if k % 2 == 0 else trees[::-1]):
            got = serve_once(t, args.arch, args.runs, args.disagg)
            per_tree[str(t)].extend(got["ms"])
            print(f"turn {k} {t}: {', '.join(f'{v:.2f}' for v in got['ms'])}"
                  f" ms a decode step ({got['decode_steps'][0]} steps a run)")
    summary = {"arch": args.arch, "disagg": args.disagg, "card": card,
               "runs": args.runs,
               "turns": args.turns, "ms": per_tree,
               "mean_ms": {t: statistics.mean(v)
                           for t, v in per_tree.items()},
               "median_ms": {t: statistics.median(v)
                             for t, v in per_tree.items()}}
    for t in per_tree:
        print(f"{t}: mean {summary['mean_ms'][t]:.2f}, median "
              f"{summary['median_ms'][t]:.2f} ms a decode step over "
              f"{len(per_tree[t])} runs")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "time_serve.json").write_text(json.dumps(summary,
                                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
