"""The port's serving loop (``repro_torch.serve``) against the reference
``ServingSession``: the golden arrivals, served with the same weights, give
identical per-request tokens (paper-gpt-32x1.3b and rwkv6-7b smoke, the
dense qwen1.5-0.5b, gemma-2b and paper-gpt-32x1.3b without MoE, and
paper-mixtral-16x2b with expert tensor parallelism 2), the port's canonical
report equals the golden co-located fixture, and the serving CLI runs on
the CPU."""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.engine import ServeConfig
from repro.serve import ServingSession, poisson_trace, replay_trace
from repro_torch.configs.base import ArchConfig as TorchArchConfig
from repro_torch.engine import ServeConfig as TorchServeConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models.decoder import check_servable, load_reference_params
from repro_torch.serve import ServingSession as TorchServingSession
from repro_torch.serve import poisson_trace as torch_poisson_trace
from repro_torch.serve import replay_trace as torch_replay_trace
from torch_cases import DENSE_ETP_CASES, port_config
import torch_threads  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "serve_report_colocated.json"
_GOLDEN_ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 3)]


def _canonical(d: dict) -> dict:
    """A report dict minus every wall-clock-derived field."""
    d = dict(d)
    for k in ("wall_s", "gen_tokens_per_s", "tokens_per_s", "latency_ms",
              "ttft_ms"):
        d.pop(k)
    d["per_request"] = [{k: v for k, v in r.items()
                         if k not in ("latency_ms", "ttft_ms")}
                        for r in d["per_request"]]
    return d


@pytest.mark.parametrize("vocab", [512, 50304])
def test_traffic_generators_match_reference(vocab):
    for a, b in ((poisson_trace(6, 0.5, vocab, prompt_len=7, gen_len=5,
                                seed=4),
                  torch_poisson_trace(6, 0.5, vocab, prompt_len=7,
                                      gen_len=5, seed=4)),
                 (replay_trace(_GOLDEN_ARRIVALS, vocab, seed=11),
                  torch_replay_trace(_GOLDEN_ARRIVALS, vocab, seed=11))):
        assert [(r.req_id, r.arrival_step, r.max_new) for r in a] == \
            [(r.req_id, r.arrival_step, r.max_new) for r in b]
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra.prompt, rb.prompt)


def test_golden_serving_tokens_and_report_match_reference():
    ref_cfg = get_config("paper-gpt-32x1.3b").smoke()
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    ref_sess = ServingSession(ref_cfg, ServeConfig(max_batch=3, max_seq=24),
                              seed=0)
    ref_rep = ref_sess.run(replay_trace(_GOLDEN_ARRIVALS,
                                        vocab=ref_cfg.vocab, seed=11))
    model = load_reference_params(
        jax.tree_util.tree_map(np.asarray, ref_sess.params), cfg,
        device="cpu")
    sess = TorchServingSession(cfg, TorchServeConfig(max_batch=3, max_seq=24),
                               device="cpu", model=model)
    rep = sess.run(torch_replay_trace(_GOLDEN_ARRIVALS, vocab=cfg.vocab,
                                      seed=11))
    assert [r.tokens for r in rep.records] == \
        [r.tokens for r in ref_rep.records]
    assert 0 < rep.decode_steps <= rep.steps and rep.overflow == 0.0
    golden = json.loads(GOLDEN.read_text())["moe"]
    got = json.loads(json.dumps(_canonical(rep.to_dict()), sort_keys=True))
    assert got == golden


def test_rwkv_serving_tokens_match_reference():
    """rwkv6-7b smoke served on the golden arrivals (prompts fed one token a
    step, each slot's RWKV-6 state reset on admission): the reference
    session's tokens per request; no MoE layer, so no balance and no
    overflow."""
    ref_cfg = get_config("rwkv6-7b").smoke()
    cfg = TorchArchConfig(**dataclasses.asdict(ref_cfg))
    ref_sess = ServingSession(ref_cfg, ServeConfig(max_batch=3, max_seq=24),
                              seed=0)
    ref_rep = ref_sess.run(replay_trace(_GOLDEN_ARRIVALS,
                                        vocab=ref_cfg.vocab, seed=11))
    model = load_reference_params(
        jax.tree_util.tree_map(np.asarray, ref_sess.params), cfg,
        device="cpu")
    sess = TorchServingSession(cfg, TorchServeConfig(max_batch=3, max_seq=24),
                               device="cpu", model=model)
    rep = sess.run(torch_replay_trace(_GOLDEN_ARRIVALS, vocab=cfg.vocab,
                                      seed=11))
    assert [r.tokens for r in rep.records] == \
        [r.tokens for r in ref_rep.records]
    assert [r.n_generated for r in rep.records] == \
        [g for _, _, g in _GOLDEN_ARRIVALS]
    assert rep.mean_balance is None and ref_rep.mean_balance is None
    assert rep.overflow == 0.0 and rep.steps == ref_rep.steps


@pytest.mark.parametrize("arch,servable", [
    ("rwkv6-7b", True), ("gemma3-4b", False), ("recurrentgemma-9b", False)],
    ids=["rwkv", "windowed", "rglru"])
def test_check_servable_takes_rwkv_and_refuses_other_blocks(arch, servable):
    """The decode step serves RWKV-6 decoders now; sliding-window attention
    and RG-LRU blocks are still refused."""
    cfg = TorchArchConfig(**dataclasses.asdict(get_config(arch)))
    if servable:
        check_servable(cfg)
        check_servable(cfg.smoke())
    else:
        with pytest.raises(ValueError, match="not ported"):
            check_servable(cfg)


@pytest.mark.parametrize("case", sorted(DENSE_ETP_CASES))
def test_serving_tokens_match_reference(case):
    """The golden arrivals served by the reference's session and by the
    port's with the same weights: the same tokens per request, the same
    step count; a dense decoder reports no balance, an MoE one the
    reference's."""
    ref_cfg = DENSE_ETP_CASES[case]()
    cfg = port_config(ref_cfg)
    ref_sess = ServingSession(ref_cfg, ServeConfig(max_batch=3, max_seq=24),
                              seed=0)
    ref_rep = ref_sess.run(replay_trace(_GOLDEN_ARRIVALS,
                                        vocab=ref_cfg.vocab, seed=11))
    model = load_reference_params(
        jax.tree_util.tree_map(np.asarray, ref_sess.params), cfg,
        device="cpu")
    sess = TorchServingSession(cfg, TorchServeConfig(max_batch=3, max_seq=24),
                               device="cpu", model=model)
    rep = sess.run(torch_replay_trace(_GOLDEN_ARRIVALS, vocab=cfg.vocab,
                                      seed=11))
    assert [r.tokens for r in rep.records] == \
        [r.tokens for r in ref_rep.records]
    assert rep.steps == ref_rep.steps and rep.overflow == 0.0
    if cfg.moe:
        assert rep.mean_balance == pytest.approx(ref_rep.mean_balance,
                                                 rel=1e-6)
    else:
        assert rep.mean_balance is None and ref_rep.mean_balance is None


@pytest.mark.parametrize("arch,flags", [
    ("qwen1.5-0.5b", []), ("gemma-2b", []),
    ("paper-mixtral-16x2b", ["--etp", "2"])], ids=["qwen", "gemma", "etp"])
def test_serve_cli_runs_on_cpu(arch, flags, capsys):
    """The serving launcher's CPU drive: every request served, the report
    as JSON; no balance without MoE layers."""
    assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3", "--prompt-len", "4", "--gen",
                           "3", "--json", *flags]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke device=cpu" in out
    report = json.loads(out[out.index("\n{") + 1:])
    assert report["requests"] == 3 and report["rejected"] == 0
    assert (report["mean_balance"] is None) == (arch != "paper-mixtral-16x2b")
