"""The MoE layer across a group of ranks (``repro_torch.moe`` over
``torch.distributed``, four gloo ranks on the CPU) against the reference's
per-device ``moe_ffn`` under ``jax.vmap(axis_name="g")``: at G=4 (2 × 2)
and G=2 (1 × 2), latin placements, 8 experts, top-2, 32 tokens a rank,
seeded inputs with no tied router probabilities.

Exact: the gathered counts, the flow and integer replica counts on every
rank, every rank's monolithic and chunked plan (given the reference's
flow), the overflow.  Within the kernel tests' f32 tolerance (2e-5): the
outputs.  Bit for bit: every (pipeline_stages, chunk_comm) against the
monolithic path.  The collectives' gradients pass ``gradcheck`` in
float64 on the 2 × 2 group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.engine import MicroEPEngine
from repro.moe import dispatch as RD
from repro.moe.experts import ExpertParams
from repro.moe.layer import moe_ffn as ref_moe_ffn
from repro.moe.router import top_k_gating
from repro_torch.launch.mesh import start_group

import torch_group_cases as C
import torch_threads  # noqa: F401

E, K, T, H, F = 8, 2, 32, 16, 24
CF, BM = 2.0, 8
GRIDS = {"2x2": (2, 2), "1x2": (1, 2)}
TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_kernels.py, float32


def _case(grid, seed):
    ref = MicroEPEngine.build(E, grid, placement="latin")
    g = grid[0] * grid[1]
    rng = np.random.default_rng(seed)
    return {
        "E": E, "top_k": K, "cf": CF, "bm": BM, "grad_tokens": 3,
        "table": np.asarray(ref.placement.table),
        "x": rng.standard_normal((g, T, H)).astype(np.float32),
        "w_router": rng.standard_normal((H, E)).astype(np.float32),
        "experts": [(rng.standard_normal(s) * 0.3).astype(np.float32)
                    for s in ((E, H, F), (E, H, F), (E, F, H))]}


def _reference(case, grid):
    """The reference's monolithic per-device layer, its counts, flow and
    every device's plans on that flow."""
    ref = MicroEPEngine.build(E, grid, placement="latin")
    g = grid[0] * grid[1]
    spec = ref.moe_spec(T, K, group_axes=("g",), capacity_factor=CF, bm=BM,
                        kernel_impl="ref")
    table = np.maximum(ref.placement.flat(), 0)
    w_router = jnp.asarray(case["w_router"])

    def per_device(x, wg, wu, wd):
        return ref_moe_ffn(spec, x, w_router, ExpertParams(wg, wu, wd))[:2]

    out, metrics = jax.jit(jax.vmap(per_device, axis_name="g"))(
        case["x"], *[w[table] for w in case["experts"]])
    ex = [np.asarray(top_k_gating(jnp.asarray(case["x"][d]), w_router,
                                  K).expert_ids).reshape(-1)
          for d in range(g)]
    input_eg = np.stack([np.bincount(e, minlength=E) for e in ex], axis=1)
    sched = jax.jit(ref.schedule)(jnp.asarray(input_eg, jnp.int32))
    st = spec.statics
    stages = sorted({RD.effective_stages(s, g) for s, _ in C.VARIANTS} - {1})
    plan_fn = jax.jit(lambda e, f, d: (
        RD.make_plan(st, e, f, d),
        {n: RD.make_chunked_plan(st, e, f, d, n) for n in stages}))
    plans, chunked = [], []
    for d in range(g):
        p, c = plan_fn(jnp.asarray(ex[d], jnp.int32), sched.flow,
                       jnp.int32(d))
        plans.append(p)
        chunked.append(c)
    return {"out": np.asarray(out),
            "overflow": np.asarray(metrics.overflow),
            "input_eg": input_eg, "flow": np.asarray(sched.flow),
            "x_int": np.asarray(sched.x_int), "plans": plans,
            "chunked": chunked}


@pytest.fixture(scope="module")
def runs():
    cases = {name: _case(grid, seed) for seed, (name, grid)
             in enumerate(GRIDS.items())}
    run = start_group(C.moe_group_rank, (cases,), 2, 2)   # while JAX runs
    ref = {name: _reference(cases[name], grid)
           for name, grid in GRIDS.items()}
    return cases, run.results(), ref


def _ranks(port, name):
    return [r[name] for r in port if name in r]


def test_no_tied_router_probabilities(runs):
    cases, _, _ = runs
    for case in cases.values():
        logits = case["x"] @ case["w_router"]
        top = np.sort(logits, axis=-1)[..., ::-1][..., :K + 1]
        assert np.min(np.abs(np.diff(top, axis=-1))) > 1e-4


@pytest.mark.parametrize("name", GRIDS)
def test_counts_flow_and_replica_counts_exact_on_every_rank(runs, name):
    _, port, ref = runs
    ranks = _ranks(port, name)
    assert len(ranks) == GRIDS[name][0] * GRIDS[name][1]
    for r in ranks:
        np.testing.assert_array_equal(r["input_eg"], ref[name]["input_eg"])
        np.testing.assert_array_equal(r["flow"], ref[name]["flow"])
        np.testing.assert_array_equal(r["x_int"], ref[name]["x_int"])


@pytest.mark.parametrize("name", GRIDS)
def test_plans_equal_reference_on_every_rank(runs, name):
    _, port, ref = runs
    for r in _ranks(port, name):
        expect = ref[name]["plans"][r["index"]]
        for f in C.PLAN_FIELDS:
            np.testing.assert_array_equal(r["plan"][f],
                                          np.asarray(getattr(expect, f)),
                                          err_msg=f)
        assert set(r["chunked"]) == set(ref[name]["chunked"][r["index"]])
        for n, plan in r["chunked"].items():
            expect = ref[name]["chunked"][r["index"]][n]
            for f in C.CHUNK_FIELDS:
                np.testing.assert_array_equal(
                    plan[f], np.asarray(getattr(expect, f)),
                    err_msg=f"{n} stages: {f}")


@pytest.mark.parametrize("name", GRIDS)
def test_outputs_and_overflow_match_reference(runs, name):
    _, port, ref = runs
    for r in _ranks(port, name):
        y, overflow, _, _ = r["variants"][(1, "ppermute")]
        np.testing.assert_allclose(y, ref[name]["out"][r["index"]], **TOL)
        assert overflow == int(ref[name]["overflow"][r["index"]]) == 0


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("variant", C.VARIANTS[1:],
                         ids=lambda v: f"{v[0]}-{v[1]}")
def test_pipelined_bit_identical_to_monolithic(runs, name, variant):
    _, port, _ = runs
    for r in _ranks(port, name):
        mono = r["variants"][(1, "ppermute")]
        got = r["variants"][variant]
        np.testing.assert_array_equal(got[0], mono[0])
        assert got[1:] == mono[1:] or all(
            np.array_equal(a, b) for a, b in zip(got[1:], mono[1:]))


@pytest.mark.parametrize("variant", C.VARIANTS, ids=lambda v: f"{v[0]}-{v[1]}")
def test_collective_gradients_pass_gradcheck(runs, variant):
    _, port, _ = runs
    assert [r["grad"][variant] for r in port] == [True] * 4
