"""Disaggregated prefill/decode serving in the port (``DisaggConfig``, the
role managers and ``HandoffBuffer`` of ``repro_torch.serve.batching``,
``decoder.extract/insert_decode_slot``, ``ServingSession(disagg=...)``)
against the reference.

The managers run in lockstep with the reference's on the deterministic
grids of ``tests/test_disagg.py``, in the two-fleet loop's tick order,
their every slot, reservation, queue and buffer counter compared each
tick.  The one-device disaggregated session serves olmoe-1b-7b smoke (and
the dense qwen1.5-0.5b smoke) from the reference's weights with the
reference session's report, wall fields aside.  The 2 × 2 group's
disaggregated run is held to the one-device port's in
``test_torch_serve_group.py``, whose four ranks it shares."""
import argparse
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.engine import DeviceProfile as RefDeviceProfile
from repro.engine import DisaggConfig as RefDisaggConfig
from repro.engine import ServeConfig as RefServeConfig
from repro.models import decoder as rdec
from repro.serve import BatchManager as RefBatchManager
from repro.serve import HandoffBuffer as RefHandoffBuffer
from repro.serve import HandoffItem as RefHandoffItem
from repro.serve import Request as RefRequest
from repro.serve import ServingSession as RefServingSession
from repro.serve import replay_trace
from repro.serve.replacement import ServeReplacement as RefServeReplacement
from repro.core.placement import vanilla_placement as ref_vanilla
from repro_torch.core.placement import vanilla_placement
from repro_torch.engine import ConfigError, DisaggConfig, ServeConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decoder as tdec
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.layers.rwkv6 import RWKVState
from repro_torch.serve import (BatchManager, HandoffBuffer, HandoffItem,
                               Request, ServeReplacement, ServingSession)
from repro_torch.serve import replay_trace as torch_replay_trace
from test_disagg import _GRID, _UNIFIED_GRID, _gaps_to_arrivals
from torch_cases import canonical, port_config, reference_params

import torch_threads  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "golden" / \
    "serve_report_colocated.json"
GOLDEN_ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 3)]
ARRIVALS = [(0, 6, 5), (0, 4, 3), (1, 5, 4), (2, 6, 6), (3, 3, 1),
            (4, 4, 4), (9, 5, 3)]
SERVE = dict(max_batch=4, max_seq=24)
DISAGG = dict(enabled=True, prefill_slots=4, decode_slots=4,
              handoff_depth=2)


def _requests(mod, arrivals, vocab=64):
    out = []
    for i, (a, p, g) in enumerate(arrivals):
        rng = np.random.default_rng(i)
        out.append(mod(req_id=i, arrival_step=a,
                       prompt=rng.integers(0, vocab, p), max_new=g))
    return out


def _snap(bm) -> tuple:
    """Everything a manager holds: its slots, reservation and queue."""
    return (tuple(None if s is None else
                  (s.request.req_id, s.slot, s.admit_step, s.fed,
                   tuple(s.tokens), s.first_token_step, s.handoff_ready)
                  for s in bm.slots),
            bm.reserved_tokens, tuple(r.req_id for r in bm.queue),
            tuple(r.req_id for r in bm.rejected), bm.n_active,
            bm.has_work())


def _two_fleets(mods, arrivals, pf_slots, dc_slots, depth, max_seq, eos):
    """The two-fleet loop's tick order on one implementation -> the
    snapshot of every tick (managers and buffer) and what finished."""
    sc, bm_cls, buf_cls, item_cls, req_cls = mods
    pf = bm_cls(sc(max_batch=pf_slots, max_seq=max_seq, eos_token=eos),
                role="prefill")
    dc = bm_cls(sc(max_batch=dc_slots, max_seq=max_seq, eos_token=eos),
                role="decode")
    buf = buf_cls(depth)
    reqs = _requests(req_cls, arrivals)
    for r in sorted(reqs, key=lambda r: (r.arrival_step, r.req_id)):
        pf.submit(r)
    ticks, finished, step, stalls = [], [], 0, 0
    while (pf.has_work() or dc.has_work() or len(buf)) and step < 2000:
        if pf.n_active == 0 and dc.n_active == 0 and not len(buf):
            nxt = pf.next_arrival_step()
            if nxt is not None and nxt > step:
                step = nxt
        while buf.peek() is not None:
            item = buf.peek()
            if dc.admit_transfer(item.seq, step) is None:
                break
            buf.pop()
        mask = pf.admit_ready(step)
        for bm in (pf, dc):
            toks, active = bm.next_tokens()
            if not active.any():
                continue
            finished += [(step, s.request.req_id, tuple(s.tokens))
                         for s in bm.observe(np.full(bm.cfg.max_batch, 7),
                                             step, 0.0)]
        for s in pf.take_handoff_ready():
            if buf.full:
                break
            assert buf.push(item_cls(seq=s, kv_bytes=16, push_step=step))
            pf.release(s)
        stalls += len(pf.take_handoff_ready())
        ticks.append((step, tuple(mask), tuple(toks.ravel().tolist()),
                      _snap(pf), _snap(dc), len(buf), buf.peak,
                      buf.transferred, buf.bytes_total, stalls))
        step += 1
    return ticks, finished


REF = (RefServeConfig, RefBatchManager, RefHandoffBuffer, RefHandoffItem,
       RefRequest)
PORT = (ServeConfig, BatchManager, HandoffBuffer, HandoffItem, Request)


@pytest.mark.parametrize("arrivals,pf,dc,depth,max_seq,eos", _GRID,
                         ids=range(len(_GRID)))
def test_role_managers_match_reference(arrivals, pf, dc, depth, max_seq,
                                       eos):
    """Prefill and decode managers and the buffer, tick by tick, equal
    the reference's: FIFO admission, budgets, depth, ordering and
    conservation follow."""
    want = _two_fleets(REF, arrivals, pf, dc, depth, max_seq, eos)
    got = _two_fleets(PORT, arrivals, pf, dc, depth, max_seq, eos)
    assert got == want
    n_fit = sum(1 for _, p, g in arrivals if p + g <= max_seq)
    assert len(got[1]) == n_fit


def _unified(mods, gaps, slots, kv_budget):
    sc, bm_cls, _, _, req_cls = mods
    bm = bm_cls(sc(max_batch=slots, max_seq=8, kv_budget=max(kv_budget, 8)))
    for r in _requests(req_cls, _gaps_to_arrivals(gaps)):
        bm.submit(r)
    ticks, step = [], 0
    while bm.has_work() and step < 2000:
        if bm.n_active == 0:
            nxt = bm.next_arrival_step()
            if nxt is not None and nxt > step:
                step = nxt
        mask = bm.admit_ready(step)
        toks, act = bm.next_tokens()
        fins = bm.observe(np.full(slots, 7), step, 0.0)
        ticks.append((step, tuple(mask), tuple(toks.ravel().tolist()),
                      tuple(act), tuple(s.request.req_id for s in fins),
                      _snap(bm)))
        step += 1
    return ticks


@pytest.mark.parametrize("gaps,slots,kv_budget", _UNIFIED_GRID,
                         ids=range(len(_UNIFIED_GRID)))
def test_unified_manager_matches_reference(gaps, slots, kv_budget):
    """The co-located manager (``role="unified"``) equals the reference's
    tick by tick."""
    assert _unified(PORT, gaps, slots, kv_budget) == \
        _unified(REF, gaps, slots, kv_budget)


def test_manager_fleet_and_recovery_helpers_match_reference():
    """``slot_limit``, ``n_active_above``, ``evict_range``,
    ``requeue_front`` and ``can_admit_transfer`` (ported for the fleet and
    resilience slices) act as the reference's."""
    def drive(mods):
        sc, bm_cls, _, _, req_cls = mods
        bm = bm_cls(sc(max_batch=4, max_seq=8, kv_budget=20))
        reqs = _requests(req_cls, [(0, 3, 2)] * 6)
        for r in reqs:
            bm.submit(r)
        out = [_snap(bm)]
        bm.set_slot_limit(2)
        out += [tuple(bm.admit_ready(0)), bm.admit_capacity, _snap(bm)]
        bm.set_slot_limit(None)
        out += [tuple(bm.admit_ready(1)), bm.n_active_above(2), _snap(bm)]
        victims = bm.evict_range(1, 3)
        out += [tuple(v.request.req_id for v in victims), _snap(bm)]
        bm.requeue_front([v.request for v in victims])
        out += [_snap(bm)]
        dc = bm_cls(sc(max_batch=1, max_seq=8), role="decode")
        seq = bm.slots[0]
        out += [dc.can_admit_transfer(seq), dc.admit_transfer(seq, 2),
                dc.can_admit_transfer(seq), _snap(dc)]
        for bad in (5, -1):
            with pytest.raises(ValueError):
                bm.set_slot_limit(bad)
        with pytest.raises(ValueError):
            bm.evict_range(3, 1)
        with pytest.raises(ValueError):
            dc.requeue_front([])
        with pytest.raises(ValueError):
            dc.submit(reqs[0])
        with pytest.raises(ValueError):
            bm_cls(sc(), role="verify")
        return out
    assert drive(PORT) == drive(REF)


def test_handoff_buffer_matches_reference():
    def drive(buf_cls, item_cls):
        with pytest.raises(ValueError):
            buf_cls(0)
        buf = buf_cls(2)
        items = [item_cls(seq=None, kv_bytes=10 + s, push_step=s)
                 for s in range(3)]
        out = [buf.push(items[0]), buf.push(items[1]), buf.full,
               buf.push(items[2]), len(buf), buf.peak, buf.bytes_total,
               buf.peek() is items[0], buf.pop() is items[0],
               buf.pop() is items[1], buf.transferred, len(buf),
               buf.peek()]
        return out
    assert drive(HandoffBuffer, HandoffItem) == \
        drive(RefHandoffBuffer, RefHandoffItem)


# ------------------------------------------------- one slot's caches


def _random_states(ref_cfg, batch: int, max_seq: int, seed: int):
    """A reference decode state with random caches and positions, and the
    port's state of the same values."""
    rng = np.random.default_rng(seed)
    ref = rdec.init_decode_state(ref_cfg, batch, max_seq, per_slot=True)

    def fill(a):
        a = np.asarray(a)
        if a.dtype.kind == "i":
            return jnp.asarray(rng.integers(0, max_seq, a.shape), a.dtype)
        return jnp.asarray(rng.standard_normal(a.shape), a.dtype)

    ref = jax.tree_util.tree_map(fill, ref)
    scan = ref["scan"][0]
    port = {"pos": torch.tensor(np.asarray(ref["pos"]), dtype=torch.int64)}
    reps = ref_cfg.num_layers
    if ref_cfg.pattern == ("rwkv",):
        port["rwkv"] = [RWKVState(*(torch.tensor(np.asarray(a[r]))
                                    for a in scan)) for r in range(reps)]
    else:
        port["kv"] = [KVCache(k=torch.tensor(np.asarray(scan.k[r])),
                              v=torch.tensor(np.asarray(scan.v[r])),
                              length=port["pos"].clone())
                      for r in range(reps)]
    return ref, port


def _leaves(port_payload) -> list:
    if "kv" in port_payload:
        return [a for c in port_payload["kv"] for a in (c.k, c.v)]
    return [a for st in port_payload["rwkv"] for a in st]


def _ref_leaves(ref_payload, layers: int) -> list:
    scan = ref_payload["scan"][0]
    fields = ("k", "v") if hasattr(scan, "k") else \
        ("wkv", "shift_t", "shift_c")
    return [np.asarray(getattr(scan, f))[r] for r in range(layers)
            for f in fields]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-7b"])
def test_slot_payloads_match_reference(arch):
    """``extract_decode_slot``'s payload, ``insert_decode_slot`` into a
    state of another width and ``decode_slot_bytes`` equal the
    reference's on the same states (KV caches, RWKV-6 states); the packed
    payload is ``decode_slot_bytes`` long and unpacks to itself."""
    ref_cfg = get_config(arch).smoke()
    ref_a, port_a = _random_states(ref_cfg, 3, 12, seed=1)
    ref_b, port_b = _random_states(ref_cfg, 2, 12, seed=2)
    assert tdec.decode_slot_bytes(port_a) == rdec.decode_slot_bytes(ref_a)
    for slot, dst in ((0, 1), (2, 0)):
        ref_p = rdec.extract_decode_slot(ref_a, slot)
        got = tdec.extract_decode_slot(port_a, slot)
        assert int(got["pos"]) == int(ref_p["pos"])
        for a, b in zip(_leaves(got), _ref_leaves(ref_p, ref_cfg.num_layers),
                        strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
        buf = tdec.pack_decode_slot(got)
        assert buf.numel() * 4 == tdec.decode_slot_bytes(port_a)
        back = tdec.unpack_decode_slot(buf, port_b)
        assert int(back["pos"]) == int(got["pos"])
        for a, b in zip(_leaves(back), _leaves(got), strict=True):
            assert torch.equal(a, b)
        ref_b = rdec.insert_decode_slot(ref_b, ref_p, dst)
        port_b = tdec.insert_decode_slot(port_b, back, dst)
    np.testing.assert_array_equal(port_b["pos"].numpy(),
                                  np.asarray(ref_b["pos"]))
    for r in range(2):
        whole = tdec.extract_decode_slot(port_b, r)
        for a, b in zip(_leaves(whole), _ref_leaves(
                rdec.extract_decode_slot(ref_b, r), ref_cfg.num_layers)):
            np.testing.assert_array_equal(a.numpy(), b)


# ----------------------------------------------------------- sessions


def disagg_runs(ref_cfg, params, arrivals, serve_kw, disagg_kw) -> tuple:
    """The reference's and the port's one-device disaggregated reports of
    the same weights and requests."""
    ref = RefServingSession(ref_cfg, RefServeConfig(**serve_kw), seed=0,
                            disagg=RefDisaggConfig(**disagg_kw)).run(
        replay_trace(arrivals, ref_cfg.vocab, seed=11))
    port = ServingSession(port_config(ref_cfg), ServeConfig(**serve_kw),
                          device="cpu", params_np=params,
                          disagg=DisaggConfig(**disagg_kw)).run(
        torch_replay_trace(arrivals, ref_cfg.vocab, seed=11))
    return ref, port


def test_disagg_session_matches_reference():
    """Per-request tokens, step-clock fields and the ``disagg`` block equal
    the reference session's; every request served once, transfers as
    many as requests that outlive their prefill, the buffer within its
    depth, handoff bytes ``decode_slot_bytes`` a transfer."""
    ref_cfg = get_config("olmoe-1b-7b").smoke()
    ref, port = disagg_runs(ref_cfg, reference_params(ref_cfg), ARRIVALS,
                            SERVE, DISAGG)
    assert [r.tokens for r in port.records] == [r.tokens for r in ref.records]
    assert canonical(port.to_dict()) == canonical(ref.to_dict())
    d = port.disagg
    assert sorted(r.req_id for r in port.records) == list(range(len(
        ARRIVALS)))
    assert d["transferred"] == sum(1 for *_, g in ARRIVALS if g > 1)
    assert d["handoff_peak"] <= DISAGG["handoff_depth"]
    assert "disagg:" in port.summary()


def test_disagg_dense_session_matches_reference():
    """The dense qwen1.5-0.5b smoke, disaggregated, equals the reference:
    no balance, the handoff stats."""
    ref_cfg = get_config("qwen1.5-0.5b").smoke()
    ref, port = disagg_runs(
        ref_cfg, reference_params(ref_cfg),
        [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 1)],
        dict(max_batch=3, max_seq=24),
        dict(enabled=True, prefill_slots=3, decode_slots=2,
             handoff_depth=2))
    assert canonical(port.to_dict()) == canonical(ref.to_dict())
    assert port.mean_balance is None and port.disagg["transferred"] == 4


def test_disabled_disagg_keeps_the_golden_report():
    """``DisaggConfig(enabled=False)`` is the co-located loop: its report
    is the golden co-located fixture, without a ``disagg`` key."""
    ref_cfg = get_config("paper-gpt-32x1.3b").smoke()
    sess = ServingSession(port_config(ref_cfg),
                          ServeConfig(max_batch=3, max_seq=24), device="cpu",
                          params_np=reference_params(ref_cfg),
                          disagg=DisaggConfig(enabled=False))
    rep = sess.run(torch_replay_trace(GOLDEN_ARRIVALS, ref_cfg.vocab,
                                      seed=11))
    assert rep.disagg is None and "disagg" not in rep.to_dict()
    assert canonical(rep.to_dict()) == \
        json.loads(GOLDEN.read_text())["moe"]


def test_fleet_tagged_decisions_match_reference():
    """A fleet's hook tags its decision records with the fleet, as the
    reference's; a co-located hook leaves them untagged."""
    sc = dict(max_batch=2, max_seq=16, replacement=True,
              repl_check_every=1, repl_threshold=1.0)
    skew = np.array([30.0, 1.0, 1.0, 1.0])
    for fleet in ("prefill", "decode", None):
        ref = RefServeReplacement(ref_vanilla(1, 1, 4), RefServeConfig(**sc),
                                  128, fleet=fleet)
        port = ServeReplacement(vanilla_placement(1, 1, 4), ServeConfig(**sc),
                                128, fleet=fleet)
        for step in range(4):
            ref.observe(skew, step=step)
            port.observe(skew, step=step)
        assert port.events and port.events == ref.events
        assert all(e.get("fleet") == fleet for e in port.events)


def test_one_device_refuses_profiles_and_run_cfg():
    """The fleets' device profiles and a ``run_cfg`` steer a group; one
    device refuses them rather than ignore them."""
    cfg = port_config(get_config("olmoe-1b-7b").smoke())
    from repro_torch.engine import RuntimeConfig
    with pytest.raises(ValueError, match="profiles"):
        ServingSession(cfg, ServeConfig(**SERVE), device="cpu",
                       disagg=DisaggConfig(**DISAGG,
                                           decode_profiles="2,1"))
    with pytest.raises(ValueError, match="run_cfg"):
        ServingSession(cfg, ServeConfig(**SERVE), device="cpu",
                       run_cfg=RuntimeConfig())


# ------------------------------------------------- DisaggConfig and CLI


def test_disagg_config_matches_reference():
    """Validation, dict and CLI round trips as the reference's."""
    for bad in (dict(prefill_slots=0), dict(decode_slots=-1),
                dict(handoff_depth=0)):
        with pytest.raises(ConfigError):
            DisaggConfig(**bad)
    kw = dict(enabled=True, prefill_slots=4, decode_slots=2,
              handoff_depth=3, prefill_profiles="2,1",
              decode_profiles=[{"weight": 1.0, "slots": 8}])
    dg, ref = DisaggConfig(**kw), RefDisaggConfig(**kw)
    assert dg.to_dict() == ref.to_dict()
    assert DisaggConfig.from_dict(ref.to_dict()) == dg
    assert dg.to_cli_args() == ref.to_cli_args()
    ap = argparse.ArgumentParser()
    DisaggConfig.add_cli_args(ap)
    assert DisaggConfig.from_cli_args(ap.parse_args(dg.to_cli_args())) == dg
    assert DisaggConfig.from_cli_args(ap.parse_args([])) == DisaggConfig()
    assert dataclasses.asdict(DisaggConfig()) == \
        dataclasses.asdict(RefDisaggConfig())
    assert RefDeviceProfile(2.0).to_dict() == dg.prefill_profiles[0].to_dict()


def test_serve_cli_disagg_on_cpu(capsys):
    assert serve_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                           "cpu", "--requests", "3", "--gen", "4",
                           "--prompt-len", "4", "--disagg",
                           "--prefill-slots", "2", "--decode-slots", "2",
                           "--handoff-depth", "1"]) == 0
    out = capsys.readouterr().out
    assert "disagg: prefill=2 decode=2 handoff_depth=1" in out
    assert "handoffs (buffer peak 1/1" in out


@pytest.mark.parametrize("flags,message", [
    (["--fleet", "--disagg"], "--fleet and --disagg cannot be combined"),
    (["--resilience"], "--resilience needs --fleet"),
    (["--capacity-factor", "4"], "--capacity-factor need --data-axis"),
    (["--disagg", "--decode-profiles", "2,1"], "need --data-axis"),
    (["--data-axis", "2", "--dtype", "bfloat16"], "serving runs in float32")],
    ids=["fleet", "resilience", "engine", "profiles", "dtype"])
def test_serve_cli_refuses(flags, message, capsys):
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                        "cpu", *flags])
    assert message in capsys.readouterr().err
