"""The port's parallel layer against the JAX package, on the CPU.

Spawned ranks joined by gloo (``parallel.multihost.launch``; the ranks run
``parallel.workers`` and import no JAX), one world of 2 ranks and one of
4, every case of a world in its one spawn:

- ``sequential_shards`` / ``distributed_concat`` against
  ``segmamba_tpu.parallel.eval``, and ``eval_map`` on two data ranks;
  ``Config.build_mesh`` of ``train.data_parallel``; ``tp_shard``'s
  ``in_proj`` split per half (each rank its channels of x and of z) and
  ``tp_gather_state`` undoing it;
- ``MambaV3`` under sequence parallelism on a ("seq",) world of 2 and
  under tensor parallelism on a ("model",) world of 2, against JAX's
  ``MambaV3(mesh=..., scan_impl="chunked")`` on 2-device meshes (JAX's
  TP with ``parallel.tp.tp_shard``): output, input gradient and every
  parameter gradient;
- the tiny SegMamba train step (2 steps, batch 2 x 16^3, float32) on a
  2 x 2 ("data", "seq") world, a ("data",) world of 2 (one sample a rank)
  and a ("model",) world of 2, each against JAX's ``train_step`` on a
  2-device ("data",) mesh from the same weights and batch: loss and
  gradient norm per step, the parameters after each step, and the
  parameters bit-equal on every rank. One JAX train-step compile serves
  the three worlds, which compute one function. JAX's ("data", "seq")
  mesh step is not the reference: on the CPU its gradient norm misses its
  own single-device and data-parallel steps' beyond rtol 1e-4 at this
  config (the class of SPMD-partitioner faults that
  ``segmamba_tpu/models/segmamba.py:75-80`` records), while those two
  agree with each other and with the port's steps.

- ``causal_conv1d_directional`` on sequences shorter than the filter's
  reach (L = 1, 2, 3), which a tensor-parallel rank's dir2 meets at stage
  3 of a 16^3 volume, against JAX's causal conv forward and flipped.

Tolerances: layer outputs at the float32 tier (rtol 6e-4 / atol 2e-3),
gradients at rtol 2e-3 / atol 1e-2 x each tensor's max |grad|; the train
steps as ``test_torch_port_train.py``'s parity (loss and gradient norm
rtol 1e-4, parameters rtol 1e-3 / atol 1e-5).

CPU time: about 60 s, most of it the JAX train-step compile.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segmamba_tpu.models import SegMamba as JSegMamba
from segmamba_tpu.models.mamba import MambaV3 as JMambaV3
from segmamba_tpu.parallel import make_mesh as j_make_mesh
from segmamba_tpu.parallel import tp_shard as j_tp_shard
from segmamba_tpu.parallel.eval import distributed_concat as j_concat
from segmamba_tpu.parallel.eval import sequential_shards as j_shards
from segmamba_tpu.train.train_state import create_train_state
from segmamba_tpu.train.train_state import train_step as j_train_step
from segmamba_tpu.utils.torch_convert import convert_segmamba_state_dict
from segmamba_tpu_torch.models import SegMamba
from segmamba_tpu_torch.models.mamba import MambaV3
from segmamba_tpu_torch.parallel import eval as t_eval
from segmamba_tpu_torch.parallel import tp
from segmamba_tpu_torch.parallel import workers
from segmamba_tpu_torch.parallel.multihost import launch
from segmamba_tpu_torch.utils.convert import (
    flax_to_state_dict,
    mamba_flax_to_state_dict,
    tp_shard_state_dict,
)

OUT_TOL = dict(rtol=6e-4, atol=2e-3)
LAYER = dict(d_model=16, d_state=4, nslices=4)
CFG = dict(in_chans=2, out_chans=3, depths=(1, 1, 1, 1),
           feat_size=(4, 8, 16, 32), hidden_size=32,
           num_slices_list=(8, 4, 2, 1))
STEPS, LR = 2, 1e-2
EVAL_ITEMS = (5, 4, 1)
TRAIN_WORLDS = {"data_seq": (4, ("data", "seq"), (2, 2)),
                "data": (2, ("data",), (2,)),
                "model": (2, ("model",), (2,))}


def _layer_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 32, 16)).astype(np.float32)
    params = JMambaV3(**LAYER, scan_impl="chunked").init(
        jax.random.key(0), jnp.asarray(x))
    return x, cot, params


def _train_inputs():
    model = SegMamba(generator=torch.Generator().manual_seed(0), **CFG)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(2)
    image = rng.standard_normal((2, 2, 16, 16, 16)).astype(np.float32)
    label = rng.integers(0, 3, (2, 16, 16, 16)).astype(np.int64)
    return state, image, label


X, COT, JPARAMS = _layer_inputs()
STATE, IMAGE, LABEL = _train_inputs()


def _train_case(axes, shape):
    return dict(axes=axes, shape=shape, model_kw=CFG, state=STATE,
                image=IMAGE, label=LABEL, steps=STEPS, lr=LR,
                num_classes=3)


@pytest.fixture(scope="module")
def worlds():
    """{world size: the launch of its world (a future of every rank's
    results by job)}: both worlds start at once and run while the JAX
    references compile."""
    state = {k: v.numpy() for k, v in mamba_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, JPARAMS)).items()}
    layer_cases = [dict(mode=m, kw=dict(LAYER, scan_impl="chunked"),
                        state=state, x=X, cot=COT) for m in ("sp", "tp")]
    with ThreadPoolExecutor(2) as pool:
        futures = {}
        for n in (2, 4):
            train = [_train_case(axes, shape) for size, axes, shape
                     in TRAIN_WORLDS.values() if size == n]
            jobs = [("train_cases", train)]
            if n == 2:
                jobs += [("mamba_cases", layer_cases),
                         ("eval_cases", EVAL_ITEMS)]
            futures[n] = pool.submit(launch, workers.many, n, jobs,
                                     device="cpu", timeout_s=600)
        yield futures


def _train_results(worlds, name):
    """Every rank's train results of one of ``TRAIN_WORLDS``."""
    n, axes, _ = TRAIN_WORLDS[name]
    sizes = [a for a in TRAIN_WORLDS.values() if a[0] == n]
    i = [a[1] for a in sizes].index(axes)
    return [rank_res[0][i] for rank_res in worlds[n].result()]


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's train step on a 2-device ("data",) mesh, twice: (loss, grad
    norm, parameters as the port's state_dict) per step."""
    mesh = j_make_mesh(2)
    jm = JSegMamba(**CFG, scan_impl="chunked")
    tree = convert_segmamba_state_dict(
        {k: torch.from_numpy(v) for k, v in STATE.items()},
        depths=CFG["depths"])
    state = create_train_state(
        jm, None, None, LR, mesh=mesh,
        params=jax.tree_util.tree_map(jnp.asarray, tree))
    batch = {"image": jnp.asarray(np.moveaxis(IMAGE, 1, -1)),
             "label": jnp.asarray(LABEL.astype(np.int32))}
    steps = []
    for _ in range(STEPS):
        state, m = j_train_step(state, batch, mesh=mesh, num_classes=3)
        params = flax_to_state_dict(jax.tree_util.tree_map(np.array,
                                                           state.params))
        steps.append((float(m["loss"]), float(m["grad_norm"]),
                      {k: v.numpy() for k, v in params.items()}))
    return steps


@pytest.mark.parametrize("n_items,n_shards", [(10, 4), (8, 4), (3, 5),
                                              (1, 1)])
def test_eval_shards_match_jax(n_items, n_shards):
    assert t_eval.sequential_shards(n_items, n_shards) == j_shards(
        n_items, n_shards)
    shards, mask = t_eval.sequential_shards(n_items, n_shards)
    per_shard = [np.asarray(s) * 10 for s in shards]
    np.testing.assert_array_equal(t_eval.distributed_concat(per_shard,
                                                            n_items),
                                  j_concat(per_shard, n_items))
    # what the ranks keep, in rank order, is every item once
    kept = [i for s, m in zip(shards, mask) for i, k in zip(s, m) if k]
    assert kept == list(range(n_items))


def test_eval_map_on_two_data_ranks(worlds):
    """Each data rank evaluates its contiguous shard (wrap-around padding
    evaluated and dropped) and both get every result in item order."""
    ranks = worlds[2].result()
    for i, n in enumerate(EVAL_ITEMS):
        shards, _ = j_shards(n, 2)
        want = [(10 * k, r) for r, shard in enumerate(shards)
                for k in shard][:n]
        assert ranks[0][2][i] == ranks[1][2][i] == want


def test_config_data_parallel_builds_the_data_mesh(tmp_path):
    """``Config.train.data_parallel``'s mesh: ("data",) over the launched
    ranks (here a world of one, joined in this process); none without
    it."""
    import torch.distributed as dist

    from segmamba_tpu_torch.config import Config, TrainConfig

    assert Config().build_mesh() is None
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = Config(train=TrainConfig(data_parallel=True)).build_mesh()
        assert (mesh.axis_names, mesh.shape, mesh.coords) == (
            ("data",), (1,), (0,))
        assert mesh.device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_tp_shard_splits_in_proj_per_half():
    layer = MambaV3(**LAYER, generator=torch.Generator().manual_seed(0))
    sd = layer.state_dict()
    E = layer.d_inner
    specs = tp.tp_specs(sd, 2)
    assert specs["in_proj.weight"] == tp.Shard(0, True)
    assert specs["x_proj_b.weight"] == tp.Shard(1)
    assert specs["out_proj.weight"] == tp.Shard(1)
    assert specs["A_s_log"] == tp.Shard(0)
    shards = [tp_shard_state_dict(sd, i, 2) for i in range(2)]
    w = sd["in_proj.weight"]
    for i, sh in enumerate(shards):
        half = E // 2
        want = torch.cat([w[i * half:(i + 1) * half],
                          w[E + i * half:E + (i + 1) * half]])
        torch.testing.assert_close(sh["in_proj.weight"], want, rtol=0,
                                   atol=0)
        assert sh["x_proj.weight"].shape == (sd["x_proj.weight"].shape[0],
                                             half)
    # a rank's shards gathered back: the whole tree
    for k, v in sd.items():
        spec = specs[k]
        if spec is None:
            continue
        parts = [s[k] for s in shards]
        if spec.halves:
            halves = [p.chunk(2, spec.dim) for p in parts]
            whole = torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                              spec.dim)
        else:
            whole = torch.cat(parts, spec.dim)
        torch.testing.assert_close(whole, v, rtol=0, atol=0, msg=k)


def _grad_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-2 * scale,
                               err_msg=name)


@pytest.mark.parametrize("mode", ["sp", "tp"])
def test_mamba_layer_matches_jax(worlds, mode):
    if mode == "sp":
        mesh = j_make_mesh(2, ("seq",))
        jm = JMambaV3(**LAYER, scan_impl="chunked", mesh=mesh,
                      seq_axis="seq")
        params = JPARAMS
    else:
        mesh = j_make_mesh(2, ("model",))
        jm = JMambaV3(**LAYER, scan_impl="chunked", mesh=mesh,
                      model_axis="model")
        params = j_tp_shard(JPARAMS, mesh)

    def out_and_grads(p, x, cot):
        out, vjp = jax.vjp(jm.apply, p, x)
        return (out,) + vjp(cot)

    out, g_params, g_x = jax.jit(out_and_grads)(params, jnp.asarray(X),
                                                jnp.asarray(COT))
    got = worlds[2].result()[0][1][["sp", "tp"].index(mode)]
    assert got["form"] == mode
    np.testing.assert_allclose(got["out"], np.asarray(out), **OUT_TOL)
    _grad_close(got["x_grad"], np.asarray(g_x), "x")
    want = mamba_flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           g_params))
    assert set(want) == set(got["grads"])
    for k, w in want.items():
        _grad_close(got["grads"][k], w.numpy(), k)


@pytest.mark.parametrize("name", list(TRAIN_WORLDS))
def test_train_step_matches_jax(worlds, jax_steps, name):
    ranks = _train_results(worlds, name)
    for step, (got, (loss, gnorm, params)) in enumerate(zip(ranks[0],
                                                            jax_steps)):
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-4,
                                   err_msg=f"loss {step}")
        np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=1e-4,
                                   err_msg=f"grad_norm {step}")
        assert set(got["params"]) == set(params)
        for k, w in params.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=1e-3,
                                       atol=1e-5, err_msg=f"{k} {step}")


@pytest.mark.parametrize("name", list(TRAIN_WORLDS))
def test_params_identical_across_ranks(worlds, name):
    ranks = _train_results(worlds, name)
    for step in range(STEPS):
        for r in ranks[1:]:
            assert r[step]["loss"] == ranks[0][step]["loss"]
            for k, v in ranks[0][step]["params"].items():
                np.testing.assert_array_equal(r[step]["params"][k], v,
                                              err_msg=f"{k} {step}")


@pytest.mark.parametrize("L", [1, 2, 3])
def test_directional_conv_shorter_than_width(L):
    """dir2's conv on a sequence shorter than the filter's reach (stage 3
    of a 16^3 volume, L = 1, which a tensor-parallel rank runs through
    dir2): the forward and flip groups are JAX's causal conv and its
    flipped form."""
    from segmamba_tpu.ops.causal_conv1d import causal_conv1d as j_conv
    from segmamba_tpu_torch.ops.causal_conv1d import (
        causal_conv1d_directional,
    )

    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, L, 5)).astype(np.float32)
    w = rng.standard_normal((2, 4, 5)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    got = causal_conv1d_directional(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), activation="silu")
    fwd = j_conv(jnp.asarray(x), w[0], b[0], activation="silu")
    flip = jnp.flip(j_conv(jnp.flip(jnp.asarray(x), 1), w[1], b[1],
                           activation="silu"), 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(fwd), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(flip), rtol=1e-6,
                               atol=1e-6)
