"""One training step on the card against the same step on the CPU's plain
path, on the smoke configs of olmoe-1b-7b, paper-gpt-32x1.3b, rwkv6-7b,
paper-mixtral-16x2b with expert tensor parallelism 2 (``smoke()`` sets
``etp`` to 1, so the case sets it back) and the dense qwen1.5-0.5b.

  PYTHONPATH=src python -m repro_torch.launch.check_train

Both sides start from the same weights (drawn on the CPU from a seed and
copied to the card) and take the same numpy batch (4 × 16 tokens, 2
micro-batches).  On the card every MoE layer of every micro-batch must run
K4 and K1 forward and K1b backward, every RWKV-6 layer K3 forward and K3b
backward, and no plain version of K1, K1b, K4, K3 or K3b; the CPU runs
exactly those plain versions (autograd of the plain K1 and of the plain
recurrence).  A dense decoder runs none of them on either side.  Held
to the tolerances of the reference's step checks: the loss within 2e-4, no
overflow, every gradient within rtol 1e-4 / atol 1e-5, the Adam moments
within rtol 2e-2 / atol 2e-4, the solver warm starts within 1e-5.  Needs a
CUDA device.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch

from ..configs import get_config
from ..data.synthetic import SyntheticLM
from ..kernels import ref
from ..kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                      grouped_ffn_flat_cuda)
from ..kernels.sched import schedule_cuda
from ..kernels.wkv6_chunk import wkv6_bwd_cuda, wkv6_cuda
from ..models import decoder as dec
from ..train.loop import init_train_state, make_train_step

CONFIGS = ("olmoe-1b-7b", "paper-gpt-32x1.3b", "rwkv6-7b")  # chip_smoke 13
BATCH, SEQ, N_MICRO = 4, 16, 2
PLAIN = ("grouped_ffn_flat_ref", "grouped_ffn_flat_bwd_ref", "schedule_ref",
         "wkv6_chunk_ref", "wkv6_bwd_ref")


@contextlib.contextmanager
def count_plain_calls():
    """Count the calls of the plain K1, K1b, K4, K3 (the recurrence, whose
    autograd is the CPU's gradient) and K3b while the block runs: yields
    {name: calls}."""
    calls = dict.fromkeys(PLAIN, 0)
    originals = {name: getattr(ref, name) for name in PLAIN}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name, fn in originals.items():
        setattr(ref, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ref, name, fn)


def smoke_config(name: str, etp: int = 1):
    """``name``'s smoke config, with expert tensor parallelism ``etp``."""
    return dataclasses.replace(get_config(name).smoke(), etp=etp)


CASES = (("olmoe-1b-7b", 1), ("paper-gpt-32x1.3b", 1),
         ("paper-mixtral-16x2b", 2), ("qwen1.5-0.5b", 1))


def kernel_launches() -> dict:
    return {"K1": grouped_ffn_flat_cuda.launches,
            "K1b": grouped_ffn_flat_bwd_cuda.launches,
            "K4": schedule_cuda.launches,
            "K3": wkv6_cuda.launches,
            "K3b": wkv6_bwd_cuda.launches}


def expected_launches(cfg, n_micro: int, steps: int = 1,
                      remat: bool = False) -> dict:
    """Each kernel's launches in ``steps`` training steps of ``cfg`` on the
    card: K4 and K1 once an MoE layer and micro-batch, K3 once an RWKV-6
    layer and micro-batch, each twice with ``remat`` (the block's forward
    runs again in the backward), and K1b and K3b once."""
    n_moe = dec.n_moe_layers(cfg) * n_micro * steps
    n_rwkv = (cfg.num_layers if tuple(cfg.pattern) == ("rwkv",) else 0) \
        * n_micro * steps
    fwd = 2 if remat else 1
    return {"K1": fwd * n_moe, "K1b": n_moe, "K4": fwd * n_moe,
            "K3": fwd * n_rwkv, "K3b": n_rwkv}


def _max_err(label: str, got: torch.Tensor, expect: torch.Tensor,
             rtol: float, atol: float) -> float:
    err = (got.detach().cpu().float() - expect.detach().float()).abs()
    if not bool(torch.isfinite(got).all()) or \
            bool((err > atol + rtol * expect.detach().float().abs()).any()):
        raise AssertionError(f"{label}: max abs err {err.max().item():.3e} "
                             f"beyond rtol {rtol} / atol {atol}")
    return err.max().item()


def card_vs_cpu(name: str, device, seed: int = 0, etp: int = 1) -> dict:
    """One step of ``name``'s smoke config (with ``etp``) on ``device`` and
    on the CPU; AssertionError on any mismatch.  -> the largest errors and
    the card's kernel launches."""
    cfg = smoke_config(name, etp)
    cpu_model = dec.init_params(cfg, seed=seed, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH,
                        seed=seed + 1).batch_at(0)
    out = {}
    for side, dev, model in (("card", device, card_model),
                             ("cpu", "cpu", cpu_model)):
        ts = init_train_state(cfg, device=dev, model=model)
        step = make_train_step(cfg, n_micro=N_MICRO, device=dev)
        before = kernel_launches()
        with count_plain_calls() as plain:
            ts, m = step(ts, batch)
        launched = {k: v - before[k] for k, v in kernel_launches().items()}
        out[side] = (ts, m, launched, dict(plain))
    (ts_c, m_c, launched, plain), (ts_h, m_h, _, plain_h) = \
        out["card"], out["cpu"]
    expect = expected_launches(cfg, N_MICRO)
    if launched != expect or any(plain.values()):
        raise AssertionError(f"{name}: card launches {launched} (expected "
                             f"{expect}), plain calls {plain}")
    if expect["K1"] and not plain_h["grouped_ffn_flat_ref"]:
        raise AssertionError(f"{name}: the CPU step ran no plain K1")
    if expect["K3"] and not plain_h["wkv6_chunk_ref"]:
        raise AssertionError(f"{name}: the CPU step ran no plain recurrence")
    loss_diff = abs(float(m_c["loss"]) - float(m_h["loss"]))
    if loss_diff >= 2e-4 or float(m_c["overflow"]) != 0.0:
        raise AssertionError(f"{name}: loss {float(m_c['loss'])} on the "
                             f"card, {float(m_h['loss'])} on the CPU; "
                             f"overflow {float(m_c['overflow'])}")
    cpu_params = dict(ts_h.model.named_parameters())
    grad_err = max(_max_err(f"{name} grad {k}", p.grad,
                            cpu_params[k].grad, 1e-4, 1e-5)
                   for k, p in ts_c.model.named_parameters())
    mom_err = max(_max_err(f"{name} {which} {k}", v,
                           getattr(ts_h.opt, which)[k], 2e-2, 2e-4)
                  for which in ("mu", "nu")
                  for k, v in getattr(ts_c.opt, which).items())
    solver_err = max((_max_err(f"{name} solver", a.x, b.x, 0.0, 1e-5)
                      for a, b in zip(ts_c.solver or (), ts_h.solver or ())),
                     default=0.0)
    return {"loss_card": float(m_c["loss"]), "loss_diff": loss_diff,
            "grad_err": grad_err, "moment_err": mom_err,
            "solver_err": solver_err, "launches": launched}


def describe(name: str, r: dict, etp: int = 1) -> str:
    return (f"{name} smoke{f' etp {etp}' if etp > 1 else ''}, one step of "
            f"{BATCH} x {SEQ} tokens in "
            f"{N_MICRO} micro-batches: loss {r['loss_card']:.6f}, card vs "
            f"CPU |dloss| {r['loss_diff']:.2e}, gradients {r['grad_err']:.2e}"
            f" (rtol 1e-4 / atol 1e-5), Adam moments {r['moment_err']:.2e}, "
            f"solver {r['solver_err']:.2e}; card launches {r['launches']}, "
            f"no plain K1, K1b, K4, K3 or K3b")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("check_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, etp in CASES:
        print(describe(name, card_vs_cpu(name, torch.device("cuda", 0),
                                         etp=etp), etp))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
