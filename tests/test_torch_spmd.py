"""Port parity for the SPMD tier (``parameter_server_tpu_torch/parallel``).

The JAX side runs in this process on the 8-device CPU mesh that conftest.py
pins; the port runs as a gloo world of CPU rank processes, one per mesh
cell (``tests/_torch_rank.py``), each with a time limit of its own
(``tests/_torch_world.py``). One world a mesh shape runs every case.
Inputs come from a numpy seed. On the CPU the port runs the plain versions
of K1, K2 and K3; the kernels are held on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import json
from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_world import rank_argvs, run_world

from parameter_server_tpu.data.batch import BatchBuilder
from parameter_server_tpu.data.synthetic import make_sparse_logistic
from parameter_server_tpu.kv.updaters import make_updater as j_make_updater
from parameter_server_tpu.parallel import make_mesh as j_make_mesh
from parameter_server_tpu.parallel import spmd as JS
from parameter_server_tpu.parallel import traffic as JT
from parameter_server_tpu.parallel.ssp import SSPClock as JClock
from parameter_server_tpu_torch.kv.updaters import Ftrl
from parameter_server_tpu_torch.parallel import spmd as TS
from parameter_server_tpu_torch.parallel import traffic as TT
from parameter_server_tpu_torch.parallel.mesh import Mesh
from parameter_server_tpu_torch.parallel.ssp import SSPClock as TClock

torch.set_num_threads(1)

TOL = {"rtol": 1e-5, "atol": 1e-6}
NUM_KEYS, ODD_KEYS, N_PER, STEPS = 512, 509, 64, 3
FTRL = {"alpha": 0.3, "lambda_l1": 0.1}
FTRL_Q = {"alpha": 0.5, "lambda_l1": 0.01}  # the JAX package's quantized-push test
CASES = [
    {"name": "ftrl_pw", "algo": "ftrl", "hyper": FTRL, "push_mode": "per_worker",
     "predict": True},
    {"name": "ftrl_agg", "algo": "ftrl", "hyper": FTRL, "push_mode": "aggregate"},
    {"name": "ftrl_q", "algo": "ftrl", "hyper": FTRL_Q, "push_mode": "quantized"},
    {"name": "ftrl_q_ref", "algo": "ftrl", "hyper": FTRL_Q, "push_mode": "per_worker"},
    {"name": "ftrl_compact", "algo": "ftrl", "hyper": FTRL, "push_mode": "per_worker",
     "compact": True},
    {"name": "sgd_pw", "algo": "sgd", "hyper": {"eta": 0.2}, "push_mode": "per_worker"},
    {"name": "sgd_agg", "algo": "sgd", "hyper": {"eta": 0.2}, "push_mode": "aggregate"},
    {"name": "adagrad_pw", "algo": "adagrad", "hyper": {"eta": 0.2, "lambda_l2": 0.5},
     "push_mode": "per_worker"},
    {"name": "adagrad_agg", "algo": "adagrad", "hyper": {"eta": 0.2, "lambda_l2": 0.5},
     "push_mode": "aggregate"},
    {"name": "ftrl_pw2", "algo": "ftrl", "hyper": FTRL, "push_mode": "per_worker",
     "steps": 2},
    {"name": "ftrl_multi", "algo": "ftrl", "hyper": FTRL, "push_mode": "per_worker",
     "steps": 2, "multistep": True},
    {"name": "ftrl_odd", "algo": "ftrl", "hyper": FTRL, "push_mode": "per_worker",
     "num_keys": ODD_KEYS, "prefix": "odd_"},
]
for _c in CASES:
    _c.setdefault("steps", STEPS)
    _c.setdefault("num_keys", NUM_KEYS)
    _c.setdefault("prefix", "")
BY_NAME = {c["name"]: c for c in CASES}
# held to the JAX step at TOL; quantized by statistics, multistep by the port's
# own single steps
EXACT_CASES = [c["name"] for c in CASES if c["push_mode"] != "quantized"]
MESHES = [(1, 2), (2, 1), (2, 2)]


def _batches(num_keys: int, d: int, step: int):
    labels, keys, vals, _ = make_sparse_logistic(
        d * N_PER, num_keys - 2, nnz_per_example=8, seed=100 + step)
    builder = BatchBuilder(num_keys=num_keys, batch_size=N_PER, max_nnz_per_example=32,
                           key_mode="identity")
    return [builder.build(labels[i * N_PER:(i + 1) * N_PER], keys[i * N_PER:(i + 1) * N_PER],
                          vals[i * N_PER:(i + 1) * N_PER]) for i in range(d)]


def _jax_case(case, mesh, batches):
    up = j_make_updater(case["algo"], **case["hyper"])
    step = JS.make_spmd_train_step(up, mesh, case["num_keys"], push_mode=case["push_mode"])
    state = JS.shard_state(up.init(case["num_keys"], 1), mesh)
    out = {k: [] for k in ("loss_sum", "examples", "probs")}
    for s in range(case["steps"]):
        stacked = JS.stack_batches(batches[s], mesh, compact=case.get("compact", False))
        state, res = step(state, stacked, s)
        for k in out:
            out[k].append(np.asarray(res[k]))
    res = {f"{k}": np.stack(v) for k, v in out.items()}
    if case.get("predict"):
        predict = JS.make_spmd_predict_step(up, mesh, case["num_keys"])
        last = JS.stack_batches(batches[case["steps"] - 1], mesh)
        res["predict"] = np.asarray(predict(state, last))
    res.update({k: np.asarray(v) for k, v in state.items()})
    return res


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(request, tmp_path_factory):
    """(mesh shape, the port's per-rank results, JAX's results, the batches)
    for every case, the port's from one world."""
    d, kv = request.param
    tmp = tmp_path_factory.mktemp(f"spmd{d}x{kv}")
    batches = {nk: [_batches(nk, d, s) for s in range(STEPS)] for nk in (NUM_KEYS, ODD_KEYS)}
    arrays = {}
    for nk, prefix in ((NUM_KEYS, ""), (ODD_KEYS, "odd_")):
        for s, group in enumerate(batches[nk]):
            for i, b in enumerate(group):
                for f in TS.CSR_FULL_FIELDS + ("row_splits",):
                    arrays[f"{prefix}s{s}_d{i}_{f}"] = getattr(b, f)
    np.savez(tmp / "inputs.npz", **arrays)
    plan = tmp / "plan.json"
    plan.write_text(json.dumps({"mesh": [d, kv], "inputs": str(tmp / "inputs.npz"),
                                "cases": CASES, "out": str(tmp)}))
    run_world(rank_argvs("spmd", plan, d * kv))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(d * kv)]
    mesh = j_make_mesh(d, kv)
    jax_out = {c["name"]: _jax_case(c, mesh, batches[c["num_keys"]]) for c in CASES}
    return (d, kv), ranks, jax_out, batches


def _tables(case):
    return ("w",) if case["algo"] == "sgd" else (("z", "n") if case["algo"] == "ftrl"
                                                  else ("w", "n"))


@pytest.mark.parametrize("name", EXACT_CASES)
def test_state_matches_jax(world, name):
    """Every rank's gathered tables equal the JAX step's (padded) tables."""
    _, ranks, jax_out, _ = world
    case = BY_NAME[name]
    for r, res in enumerate(ranks):
        for t in _tables(case):
            np.testing.assert_allclose(res[f"{name}/{t}"], jax_out[name][t], **TOL,
                                       err_msg=f"rank {r} {t}")


@pytest.mark.parametrize("name", EXACT_CASES)
def test_loss_examples_probs_match_jax(world, name):
    """loss_sum and examples of every step on every rank, and rank (d, k)'s
    probabilities against the JAX step's shard d."""
    (d_n, kv), ranks, jax_out, _ = world
    j = jax_out[name]
    for r, res in enumerate(ranks):
        d = r // kv
        np.testing.assert_allclose(res[f"{name}/loss_sum"], j["loss_sum"], **TOL)
        np.testing.assert_array_equal(res[f"{name}/examples"], j["examples"])
        np.testing.assert_allclose(res[f"{name}/probs"], j["probs"][:, d], **TOL)


def test_quantized_push_tracks_per_worker(world):
    """int8 gradients on the wire: the rounding noise is the only change. The
    port's draws are not jax.random's, so its weights are held to their
    distance from the exact per_worker run: of the order of the JAX push's
    distance from its own exact run on the same data. The kv ranks of a data
    row quantize alike (every rank holds the same tables)."""
    _, ranks, jax_out, _ = world
    up = Ftrl(**FTRL_Q)

    def weights(tables, prefix=""):
        return up.weights({k: torch.tensor(tables[prefix + k]) for k in ("z", "n")}).numpy()

    ref = weights(ranks[0], "ftrl_q_ref/")
    got = weights(ranks[0], "ftrl_q/")
    jax_dist = np.abs(weights(jax_out["ftrl_q"]) - weights(jax_out["ftrl_q_ref"])).max()
    dist = np.abs(got - ref).max()
    assert 0 < dist <= 2 * jax_dist + 1e-3, (dist, jax_dist)
    for res in ranks[1:]:
        np.testing.assert_array_equal(weights(res, "ftrl_q/"), got)


def test_quantized_ranks_audit_their_rounding(world):
    """Every rank held each of its quantized pushes, as its gradient came
    back from the gather, to the rounding bounds: no scale off the JAX
    push's, no q off floor(t) + {0, 1}."""
    _, ranks, _, _ = world
    for r, res in enumerate(ranks):
        assert res["ftrl_q/audit"].tolist() == [BY_NAME["ftrl_q"]["steps"], 0, 0], r


def test_rounding_audit_counts_faults():
    """The audit itself: a clean push counts nothing; a q moved off its
    grid and a scale off max|g| / 127 are counted."""
    rng = np.random.default_rng(4)
    g = torch.from_numpy((rng.normal(size=(512, 1)) * 0.01).astype(np.float32))
    q, scale = TS.quantize_int8(g, TS.push_generator(1, 0, 0, g.device))
    audit = {}
    TS.audit_rounding(audit, g, q, scale)
    bad = q.clone()
    bad[:3] = torch.where(bad[:3] > 0, bad[:3] - 2, bad[:3] + 2)
    TS.audit_rounding(audit, g, bad, scale * 1.5)
    assert (audit["pushes"], int(audit["off_grid"]), int(audit["scale_mismatch"])) == (2, 3, 1)


def test_sgd_aggregate_equals_per_worker(world):
    """A linear delta: aggregate-then-update is the sum of the per-worker
    updates (held as the JAX package's test holds it)."""
    _, ranks, _, _ = world
    for res in ranks:
        np.testing.assert_allclose(res["sgd_agg/w"], res["sgd_pw/w"], rtol=0, atol=1e-6)


def test_multistep_equals_single_steps(world):
    """Two microsteps in one call are the two single steps, bit for bit."""
    _, ranks, _, _ = world
    for res in ranks:
        for k in ("z", "n", "loss_sum", "examples", "probs"):
            np.testing.assert_array_equal(res[f"ftrl_multi/{k}"], res[f"ftrl_pw2/{k}"])


def test_predict_matches_jax_and_train_probs(world):
    (_, kv), ranks, jax_out, _ = world
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["ftrl_pw/predict"], jax_out["ftrl_pw"]["predict"][r // kv],
                                   **TOL)
        assert not np.allclose(res["ftrl_pw/predict"], 0.5)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_untouched_and_pad_rows_keep_their_bits(world, name):
    """Rows no batch touched, the kv pad rows past num_keys among them, stay
    exactly zero; pad row 0 too (AdaGrad with l2 > 0 relies on it)."""
    (d, kv), ranks, _, batches = world
    case = BY_NAME[name]
    touched = np.zeros(TS.padded_num_keys(case["num_keys"], kv), dtype=bool)
    for group in batches[case["num_keys"]][: case["steps"]]:
        for b in group:
            touched[b.unique_keys[1: b.num_unique]] = True
    for res in ranks:
        for t in _tables(case):
            table = res[f"{name}/{t}"]
            assert table.shape == (len(touched), 1)
            assert np.all(table[~touched] == 0.0), t
            assert np.any(table[touched] != 0.0), t


def test_kv_ranks_of_a_row_agree(world):
    (_, kv), ranks, _, _ = world
    for r, res in enumerate(ranks):
        first = ranks[(r // kv) * kv]
        for name in BY_NAME:
            np.testing.assert_array_equal(res[f"{name}/probs"], first[f"{name}/probs"])
            np.testing.assert_array_equal(res[f"{name}/loss_sum"], first[f"{name}/loss_sum"])


# --- helpers, in this process ---------------------------------------------


@pytest.mark.parametrize("num_keys,kv", [(510, 8), (512, 8), (1, 8), (509, 2), (7, 1)])
def test_padded_num_keys_matches_jax(num_keys, kv):
    assert TS.padded_num_keys(num_keys, kv) == JS.padded_num_keys(num_keys, kv)
    assert TS._shard_size(num_keys, kv) == JS._shard_size(num_keys, kv)


def test_padded_num_keys_refuses_zero():
    for f in (TS.padded_num_keys, JS.padded_num_keys):
        with pytest.raises(ValueError, match="num_keys"):
            f(0, 8)


@pytest.mark.parametrize("compact,f16", [(False, False), (True, False), (True, True)])
def test_stack_batches_matches_jax(compact, f16):
    """A rank's batch_arrays are shard d's row of JAX's stack_batches, and
    its (K, ...) step groups shard d's row of JAX's (D, K, ...) groups."""
    group = _batches(NUM_KEYS, 3, 0)
    group[1].values[0] = 1e6  # beyond float16: clipped, not inf
    want = JS.stack_batches(group, None, compact=compact, values_f16=f16)
    for d, b in enumerate(group):
        got = TS.batch_arrays(b, compact=compact, values_f16=f16)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k][d], err_msg=k)
    steps = [_batches(NUM_KEYS, 2, s) for s in range(2)]
    want = JS.stack_step_groups([JS.stack_batches(g, None, compact=compact) for g in steps])
    for d in range(2):
        got = TS.stack_step_groups([TS.batch_arrays(g[d], compact=compact) for g in steps])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k][d], err_msg=k)


def test_row_ids_from_row_splits_match_jax():
    b = _batches(NUM_KEYS, 1, 1)[0]
    fields = {f: getattr(b, f) for f in TS.CSR_COMPACT_FIELDS}
    got = TS._row_ids_of({k: torch.from_numpy(v) for k, v in fields.items()})
    want = JS._row_ids_of({k: jnp.asarray(v) for k, v in fields.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[: b.num_entries], b.row_ids[: b.num_entries])
    f16 = TS._values_of({"values": torch.from_numpy(b.values.astype(np.float16))})
    assert f16.dtype == torch.float32


def _cpu_mesh() -> Mesh:
    """A 1x1 mesh view with no world behind it: enough for the checks that
    raise before any collective."""
    return Mesh(data=1, kv=1, d=0, k=0, device=torch.device("cpu"))


def test_push_mode_validated():
    from parameter_server_tpu_torch.models.matrix_fac import make_mf_spmd_train_step
    from parameter_server_tpu_torch.kv.updaters import Adagrad

    for maker in (TS.make_spmd_train_step, TS.make_spmd_train_multistep):
        with pytest.raises(ValueError, match="push_mode"):
            maker(Ftrl(), _cpu_mesh(), NUM_KEYS, push_mode="bsp")
        with pytest.raises(ValueError, match="push_mode"):
            JS.make_spmd_train_step(j_make_updater("ftrl"), j_make_mesh(2, 4), NUM_KEYS,
                                    push_mode="bsp")
    with pytest.raises(ValueError, match="push_mode"):
        make_mf_spmd_train_step(Adagrad(), Adagrad(), _cpu_mesh(), 8, 8, 0.0,
                                push_mode="quantized")


@pytest.mark.parametrize("multistep", [False, True])
def test_quantized_push_needs_a_seed(multistep):
    maker = TS.make_spmd_train_multistep if multistep else TS.make_spmd_train_step
    step = maker(Ftrl(), _cpu_mesh(), NUM_KEYS, push_mode="quantized")
    with pytest.raises(ValueError, match="push_seed"):
        step({}, {})


def test_quantize_int8_matches_jax_scale_and_rounds_both_ways():
    """The JAX push's scale bit for bit; each q is floor(t) or floor(t) + 1
    (clipped at +-127); the mean decode over seeds is unbiased; neighbouring
    seeds round independently (F2's bounds, ROADMAP queue 3)."""
    rng = np.random.default_rng(3)
    g = (rng.normal(size=(4096, 1)) * 0.01).astype(np.float32)
    tg = torch.from_numpy(g)
    # the reference expression jitted, as the JAX push runs it: XLA folds
    # the division into a product with float32(1/127)
    want_scale = np.asarray(jax.jit(lambda x: jnp.max(jnp.abs(x)) / 127.0 + 1e-30)(
        jnp.asarray(g)))
    decodes, residuals = [], []
    for seed in range(256):
        q, scale = TS.quantize_int8(tg, TS.push_generator(seed, 0, 0, tg.device))
        assert q.dtype == torch.int8
        assert scale.item() == want_scale
        t = tg / scale
        fl = torch.floor(t)
        assert bool(((q.float() == fl) | (q.float() == fl + 1)).all())
        decodes.append(q.float() * scale)
        if seed < 2:
            residuals.append((q.float() - t).ravel())
    mean = torch.stack(decodes).mean(0)
    assert (mean - tg).abs().max().item() < 4 * want_scale / np.sqrt(256)
    rho = torch.corrcoef(torch.stack(residuals))[0, 1].item()
    assert abs(rho) < 0.1


def test_push_generator_streams():
    def draws(*args):
        return torch.rand(64, generator=TS.push_generator(*args, torch.device("cpu")))

    assert torch.equal(draws(5, 1, 0), draws(5, 1, 0))
    for other in ((6, 1, 0), (5, 0, 0), (5, 1, 1)):
        assert not torch.equal(draws(5, 1, 0), draws(*other))


@pytest.mark.parametrize("mode", ["per_worker", "aggregate", "quantized"])
@pytest.mark.parametrize("d,kv", [(1, 1), (8, 4), (2, 3)])
def test_traffic_copy_matches_jax(mode, d, kv):
    kw = {"push_mode": mode, "num_keys": 1 << 14}
    assert astuple(TT.linear_step_traffic(4096, 2, d, kv, **kw)) == \
        astuple(JT.linear_step_traffic(4096, 2, d, kv, **kw))
    assert astuple(TT.wire_step_traffic(100, 4, send_keys=mode == "aggregate")) == \
        astuple(JT.wire_step_traffic(100, 4, send_keys=mode == "aggregate"))
    assert TT.quantization_savings(d) == JT.quantization_savings(d)


def test_ssp_clock_copy_matches_jax():
    """The same calls give the same gate decisions and progress."""
    clocks = [TClock(3, 1), JClock(3, 1)]
    seen = []
    for c in clocks:
        trace = []
        for w, s in [(0, 0), (0, 1), (1, 0), (2, 0), (0, 2), (1, 1)]:
            trace.append((c.ready(w, s + 1), c.wait(w, s + 2, timeout=0.0)))
            c.finish(w, s)
        c.retire(2)
        trace.append((c.is_retired(2), c.ready(0, 4)))
        prog = c.progress()
        trace.append({k: prog[k] for k in ("min_finished", "max_finished", "retired")})
        c2 = type(c)(3, 0)
        c2.load_state_dict(c.state_dict())
        trace.append(c2.state_dict())
        seen.append(trace)
    assert seen[0] == seen[1]
