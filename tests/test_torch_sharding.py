"""The port's sharding rules on DTensor (``repro_torch.sharding``), the
parameters' logical axes (``models/convert.py::param_axes``), the sharded
training step and the re-mesh restore, against the reference
(``repro.sharding``, its axes trees and checkpoints) on the same inputs.

Multi-rank checks run in ``gloo`` process groups of at most 4 ranks on the
CPU (``launch.mesh.run_ranks``); the (2, 4) shard slices come from one
process that joins a fake 8-rank world as each rank in turn.  The rank
functions import neither jax nor the reference.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.convert import axes_tree, param_axes
from repro_torch.sharding import (ACT_RULES, PARAM_RULES, constrain,
                                  placements_for, rules_for, spec_for)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# Children of these tests (reference compiles, gloo ranks) run below the
# test process's priority, so they take only the CPU that the
# timing-gated tests running beside them in a parallel run leave.
NICE = ("nice", "-n", "10")


def _background():
    os.nice(10)


MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (1, 1): ("data", "model")}


def _mesh(shape):
    """A stand-in with the reference's mesh attributes, read by both
    packages' ``spec_for``."""
    return types.SimpleNamespace(axis_names=MESHES[shape],
                                 devices=np.empty(shape, dtype=object))


def _param_shapes(cfg):
    from repro_torch.launch.specs import abstract_model_state
    return {k: tuple(t.shape) for k, t in
            abstract_model_state(cfg)[0].items()}


def _act_cases(cfg):
    """(shape, axes) of the activations the model constrains, at a
    production-like size."""
    B, S, D = 256, 4096, cfg.d_model
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    E = cfg.moe.n_experts if cfg.moe else 8
    return [((B, S, D), ("batch", "seq", "act_embed")),
            ((B, S, cfg.vocab), ("batch", "seq", "vocab_out")),
            ((B, S, H, dh), ("batch", "seq", "act_heads", None)),
            ((B, S, KV, dh), ("batch", "seq", "act_kv", None)),
            ((B, E, 640, D), ("batch", "expert", "capacity", "act_embed")),
            ((1, 524288, D), ("batch", "seq", "act_embed"))]


@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_equals_the_references(arch):
    """(a) Every parameter of the FULL config under the param, decode and
    (for an MoE) its own expert rules, and the model's activations under
    the act, seq_sharded and sp rules, on every mesh: the same spec."""
    from repro.configs import get_arch as ref_arch
    from repro.sharding import rules as ref_rules
    cfg, rcfg = get_arch(arch).full, ref_arch(arch).full
    shapes, axes = _param_shapes(cfg), param_axes(cfg)
    variants = [dict(param=True), dict(param=True, decode=True)]
    acts = [dict(param=False), dict(param=False, seq_sharded=True),
            dict(param=False, sp=True)]
    n = 0
    for shape in MESHES:
        mesh = _mesh(shape)
        for kw in variants + acts:
            rules = rules_for(cfg, **kw)
            assert rules == ref_rules.rules_for(rcfg, **kw), kw
            cases = ([(shapes[k], axes[k]) for k in shapes]
                     if kw["param"] else _act_cases(cfg))
            for dims, names in cases:
                got = spec_for(dims, names, rules, mesh)
                want = tuple(ref_rules.spec_for(dims, names, rules, mesh))
                assert got == want, (arch, shape, kw, dims, names)
                n += 1
    assert n > 0
    if cfg.moe is not None:
        assert rules_for(cfg)["expert"] == ref_rules.rules_for(
            rcfg)["expert"] == (None if cfg.moe.sharding == "tp"
                                else "model")


@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_equal_the_references_tree(arch):
    """(b) The axes of every state-dict entry are the reference's axes
    tree under ``convert.py``'s naming, without the stacked layer dim;
    ``axes_tree`` is the reference's tree itself."""
    import jax
    from repro.configs import get_arch as ref_arch
    from repro.models import build
    from repro.models.layers import abstract_init
    cfg = get_arch(arch).full
    with abstract_init():
        _, ref_axes = build(ref_arch(arch).full).init(jax.random.key(0))
    assert axes_tree(cfg) == ref_axes
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            else:
                flat[".".join(path + [k])] = v
    walk(ref_axes, [])
    stacks = {"blocks": "layers" if cfg.family != "hybrid" else "blocks",
              "enc_layers": "enc_layers", "dec_layers": "dec_layers"}
    for key, names in param_axes(cfg).items():
        top, _, rest = key.partition(".")
        i, _, leaf = rest.partition(".")
        if top in stacks and i.isdigit():
            assert flat[f"{stacks[top]}.{leaf}"] == ("layers",) + names, key
        else:
            assert flat["embed.tokens" if key == "embed" else key] == \
                names, key


def test_spec_algorithm_cases():
    """The reference's own spec cases (``tests/test_sharding.py``) and the
    divisibility fallback on a 16-way axis."""
    m = _mesh((1, 1))
    assert spec_for((64, 64), ("embed", "mlp"), PARAM_RULES, m) == \
        ("data", "model")
    assert spec_for((4, 4), ("mlp", "mlp"), {"mlp": "model"}, m) == \
        ("model",)
    assert spec_for((3, 3), (None, None), PARAM_RULES, m) == ()
    assert spec_for((8, 8, 8), ("embed", None, None), PARAM_RULES, m) == \
        ("data",)
    big = _mesh((16, 16))
    assert spec_for((256206, 1024), ("vocab", "embed"), PARAM_RULES,
                    big) == (None, "data")          # seamless' vocab
    dec = rules_for(get_arch("gemma-7b").full, decode=True)
    assert spec_for((256000, 3072), ("vocab", "embed"), dec, big) == \
        (("data", "model"),)
    assert spec_for((256, 4096), ("batch", None), ACT_RULES,
                    _mesh((2, 16, 16))) == (("pod", "data"),)


def test_constrain_is_a_no_op_outside_a_context():
    """(e)"""
    x = torch.ones(4, 4)
    assert constrain(x, ("batch", None)) is x


# -- (c) shard slices against jax's NamedSharding ---------------------------

SLICE_CASES = [((16, 24), ("data", "model")), ((16, 24), ("model", None)),
               ((16, 24), (("data", "model"), None)),
               ((8, 16, 12), (None, ("data", "model"), None)),
               ((8, 16, 12), ("model", None, "data")),
               ((24, 16), (None, "data"))]

_JAX_SLICES = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
out = []
for shape, spec in json.loads(sys.argv[1]):
    spec = [tuple(s) if isinstance(s, list) else s for s in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out.append([[[sl.start or 0, sl.stop if sl.stop is not None else n]
                 for sl, n in zip(m[d], shape)]
                for d in mesh.devices.flat])
print("RESULT" + json.dumps(out))
"""

_TORCH_SLICES = r"""
import json, sys
import torch, torch.distributed as dist
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.sharding import distribute, placements_for
cases = json.loads(sys.argv[1])
out = [[] for _ in cases]
for rank in range(8):
    fake_world(8, rank=rank)
    mesh = make_mesh((2, 4), ("data", "model"))
    for i, (shape, spec) in enumerate(cases):
        spec = tuple(tuple(s) if isinstance(s, list) else s for s in spec)
        # each element holds its own flat index
        full = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
        loc = distribute(full, (mesh, placements_for(spec, mesh))).to_local()
        idx = torch.stack(torch.unravel_index(loc.reshape(-1), shape))
        out[i].append([[int(idx[d].min()), int(idx[d].max()) + 1]
                       for d in range(len(shape))])
    dist.destroy_process_group()
print("RESULT" + json.dumps(out))
"""


def _result(script, arg, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    p = subprocess.run([*NICE, sys.executable, "-c", script, arg],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


def test_shard_slices_equal_jax_named_sharding():
    """(c) On a (2, 4) mesh rank r holds the block NamedSharding gives
    device r of the row-major mesh, for one- and two-axis dims alike."""
    arg = json.dumps(SLICE_CASES)
    want = _result(_JAX_SLICES, arg, {"JAX_PLATFORMS": "cpu"})
    got = _result(_TORCH_SLICES, arg)
    assert got == want


def test_placements_of_a_two_axis_dim():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert placements_for((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements_for((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements_for((("model", "data"),), mesh)


# -- (f) the sharded step on 4 gloo ranks ------------------------------------

def _smoke():
    return get_arch("st-100m").smoke.with_(dtype="float32",
                                           param_dtype="float32")


def _sharded_step_rank(rank):
    """One (2, 2) step's loss and gradients, and the updated parameters,
    gathered whole."""
    _background()
    torch.set_num_threads(1)
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import family_module
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.sharding import activation_sharding
    from repro_torch.train.loop import (_skeleton, make_sharded_train_step,
                                        shard_train_state, value_and_grad)
    cfg = _smoke()
    mesh = make_mesh((2, 2), ("data", "model"))
    model = family_module(cfg).init(cfg, 0, "cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    dcfg = DataConfig(seq_len=32, global_batch=8, vocab=cfg.vocab)
    p, o = shard_train_state(cfg, params, init_opt_state(params), mesh)
    batch = device_batch(dcfg, 0, "cpu", mesh=mesh)
    with activation_sharding(mesh, rules_for(cfg, param=False)):
        total, info, grads = value_and_grad(_skeleton(cfg), p, batch)
    new_p, _, m = make_sharded_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10), mesh)(
            p, o, batch)
    return (float(info["loss"].full_tensor()),
            {k: g.full_tensor().numpy() for k, g in grads.items()},
            {k: t.full_tensor().numpy() for k, t in new_p.items()},
            float(m["loss"].full_tensor()))


def test_sharded_step_equals_the_unsharded_step():
    """(f) st-100m's smoke config, float32, on a (2, 2) mesh of 4 gloo
    ranks: the loss, every gradient and every updated parameter within
    1e-5 of their scale of the unsharded port step's, on every rank."""
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.models import family_module
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train.loop import (_skeleton, make_train_step,
                                        value_and_grad)
    cfg = _smoke()
    model = family_module(cfg).init(cfg, 0, "cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    batch = device_batch(DataConfig(seq_len=32, global_batch=8,
                                    vocab=cfg.vocab), 0, "cpu")
    _, info, grads = value_and_grad(_skeleton(cfg), params, batch)
    new_p, _, m = make_train_step(cfg, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))(
            params, init_opt_state(params), batch)
    for loss, g, p, step_loss in run_ranks(_sharded_step_rank, 4):
        assert abs(loss - float(info["loss"])) <= 1e-5 * abs(loss)
        assert step_loss == loss
        for want, got in ((grads, g), (new_p, p)):
            assert set(got) == set(want)
            for k, w in want.items():
                scale = float(w.abs().max())
                assert np.abs(got[k] - w.numpy()).max() <= 1e-5 * scale, k


# -- sequence parallelism: the sharded step with SP's seams --------------

# (arch, seq): st-100m at 32 tokens gathers the sequence for its MLP, at
# 256 keeps its shard and gathers the weights (``weights_cheaper``);
# mixtral's MoE and attention gather the sequence
SP_CASES = (("st-100m", 32), ("st-100m", 256), ("mixtral-8x22b", 32))


def _sp_config(arch):
    return get_arch(arch).smoke.with_(dtype="float32", param_dtype="float32")


def _recording_routes(store):
    """``moe.route`` recording each call's expert ids into ``store``."""
    from repro_torch.models import moe
    route = moe.route

    def recorded(p, cfg, x):
        probs, gates, ids = route(p, cfg, x)
        store.append(ids.detach().clone())
        return probs, gates, ids
    return recorded


def _sp_rank(rank, arch, seq):
    """One (2, 2) step under the SP rules: the loss and gradients (as
    ``value_and_grad`` gives them), the updated parameters, gathered
    whole, and the expert ids of each layer's forward routing."""
    _background()
    torch.set_num_threads(1)
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import family_module, moe
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.sharding import activation_sharding
    from repro_torch.train.loop import (_skeleton, make_sharded_train_step,
                                        shard_train_state, value_and_grad)
    cfg = _sp_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"))
    model = family_module(cfg).init(cfg, 0, "cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    dcfg = DataConfig(seq_len=seq, global_batch=8, vocab=cfg.vocab)
    p, o = shard_train_state(cfg, params, init_opt_state(params), mesh)
    batch = device_batch(dcfg, 0, "cpu", mesh=mesh)
    ids = []
    moe.route = _recording_routes(ids)
    with activation_sharding(mesh, rules_for(cfg, param=False, sp=True)):
        total, info, grads = value_and_grad(_skeleton(cfg), p, batch)
    ids = [t.numpy() for t in ids[:cfg.n_layers]]
    new_p, _, m = make_sharded_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10), mesh,
        sp=True)(p, o, batch)
    return (float(info["loss"].full_tensor()),
            {k: g.full_tensor().numpy() for k, g in grads.items()},
            {k: t.full_tensor().numpy() for k, t in new_p.items()},
            float(m["loss"].full_tensor()), ids)


# Adam's first update of an element is lr · g / (|g| + eps) (g clipped):
# where |g| is within the gradients' own tolerance (1e-5 of their scale)
# of zero, g's sign and size, and so the update, are not fixed by that
# tolerance, and a gradient summed in another order (SP reduces each
# weight's gradient over batch and sequence shards) moves it by up to lr.
# blocks.0.mlp.wo[25, 34] of st-100m at 32 tokens: -3.33e-8 unsharded,
# -6.38e-8 under SP, of a scale of 0.38.  There the step is held to the
# unsharded AdamW on the gathered gradients instead.
NOISE = 1e-5


@pytest.mark.parametrize("arch,seq", SP_CASES)
def test_sequence_parallel_step_equals_the_unsharded_step(arch, seq,
                                                          monkeypatch):
    """A (2, 2) step of 4 gloo ranks under sequence parallelism
    (``make_sharded_train_step(..., sp=True)``): the loss and every
    gradient within 1e-5 of their scale of the unsharded step's; every
    updated parameter within 1e-5 of its scale of the unsharded AdamW
    step on the gathered gradients, and of the unsharded step's wherever
    the gradient is above ``NOISE`` of its scale (elsewhere the update is
    not fixed by the gradients' tolerance); an MoE's expert ids equal,
    layer by layer."""
    from repro_torch.data import DataConfig, device_batch
    from repro_torch.models import family_module, moe
    from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
    from repro_torch.train.loop import (_skeleton, make_train_step,
                                        value_and_grad)
    cfg = _sp_config(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model = family_module(cfg).init(cfg, 0, "cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    batch = device_batch(DataConfig(seq_len=seq, global_batch=8,
                                    vocab=cfg.vocab), 0, "cpu")
    ids = []
    monkeypatch.setattr(moe, "route", _recording_routes(ids))
    _, info, grads = value_and_grad(_skeleton(cfg), params, batch)
    ids = [t.numpy() for t in ids[:cfg.n_layers]]
    new_p, _, m = make_train_step(cfg, opt)(params, init_opt_state(params),
                                           batch)
    for loss, g, p, step_loss, got_ids in run_ranks(_sp_rank, 4,
                                                    args=(arch, seq)):
        assert abs(loss - float(info["loss"])) <= 1e-5 * abs(loss)
        assert step_loss == loss
        assert set(g) == set(p) == set(grads)
        again = apply_updates(opt, params, {
            k: torch.from_numpy(v) for k, v in g.items()},
            init_opt_state(params))[0]
        for k, w in grads.items():
            w = w.numpy()
            scale = np.abs(w).max()
            assert np.abs(g[k] - w).max() <= 1e-5 * scale, k
            for want, where in ((again[k].numpy(), True),
                                (new_p[k].numpy(),
                                 np.abs(w) > NOISE * scale)):
                err = np.where(where, np.abs(p[k] - want), 0.0)
                assert err.max() <= 1e-5 * np.abs(want).max(), k
        assert len(got_ids) == len(ids) == (cfg.n_layers if cfg.moe
                                            else 0)
        for a, b in zip(got_ids, ids):
            np.testing.assert_array_equal(a, b)


def _vocab_ce_rank(rank):
    """``chunked_ce_from_hidden`` on a (2, 2) mesh without SP: the hidden
    states batch-cut, the head's vocab over ``model``.  Its loss, the
    gradients of the hidden states and of the head, and the collectives
    it issues."""
    _background()
    torch.set_num_threads(1)
    from repro_torch.core.hlo import collectives_of
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import chunked_ce_from_hidden
    from repro_torch.sharding import activation_sharding, distribute
    from torch.distributed.tensor import Replicate, Shard
    cfg, x, head, labels = _vocab_ce_inputs()
    mesh = make_mesh((2, 2), ("data", "model"))
    dx = distribute(x, (mesh, (Shard(0), Replicate()))).requires_grad_()
    dh = distribute(head, (mesh, (Replicate(), Shard(1)))).requires_grad_()
    dl = distribute(labels, (mesh, (Shard(0), Replicate())))
    with activation_sharding(mesh, rules_for(cfg, param=False)):
        loss = chunked_ce_from_hidden({"embed": dh, "head": dh}, cfg, dx,
                                      dl, chunk=8)
        loss.backward()
        coll = collectives_of(lambda: chunked_ce_from_hidden(
            {"embed": dh, "head": dh}, cfg, dx.detach(), dl, chunk=8))
    return (float(loss.full_tensor()), dx.grad.full_tensor().numpy(),
            dh.grad.full_tensor().numpy(), dict(coll.bytes_by_op))


def _vocab_ce_inputs():
    cfg = _smoke().with_(tie_embeddings=False)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 16, cfg.d_model), generator=g)
    head = torch.randn((cfg.d_model, cfg.vocab), generator=g) * 0.3
    labels = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    return cfg, x, head, labels


def test_chunked_loss_runs_on_the_vocab_shards():
    """Without SP, ``chunked_ce_from_hidden`` on DTensors takes the
    logsumexp on the logits' vocab shards: loss and gradients within
    1e-5 of scale of the unsharded loss's, and no collective carries the
    (B, S, V) logits (a rank's 2 x 8 x 256 float32 chunk, 16 KiB)."""
    from repro_torch.models.transformer import chunked_ce_from_hidden
    cfg, x, head, labels = _vocab_ce_inputs()
    x, head = x.requires_grad_(), head.requires_grad_()
    loss = chunked_ce_from_hidden({"embed": head, "head": head}, cfg, x,
                                  labels, chunk=8)
    loss.backward()
    for got, gx, gh, coll in run_ranks(_vocab_ce_rank, 4):
        assert abs(got - float(loss)) <= 1e-5 * abs(float(loss))
        for a, b in ((gx, x.grad), (gh, head.grad)):
            b = b.numpy()
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        assert coll.get("all-gather", 0) < 2 * 8 * cfg.vocab * 4, coll


_SP_DRYRUN = r"""
import json, sys
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch import dryrun
import repro_torch.configs.base as base
from repro_torch.configs import get_arch
fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"))
base.SHAPES["t_train"] = base.InputShape("t_train", 128, 8, "train")
cfg = get_arch(sys.argv[1]).smoke.with_(dtype="float32",
                                        param_dtype="float32")
out = {sp: dryrun.run_cell(sys.argv[1], "t_train", cfg_override=cfg,
                           mesh=mesh, probes=False, sp=sp)["memory"]
       for sp in (True, False)}
print("RESULT" + json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x22b"])
def test_sequence_parallel_dryrun_keeps_fewer_temp_bytes(arch):
    """On the (2, 4) fake mesh a training cell with SP keeps the residual
    stream cut along the sequence, so the bytes its backward keeps (temp)
    are fewer than the same cell's without SP; its arguments and outputs
    are the same."""
    got = _result(_SP_DRYRUN, arch)
    sp, full = got["true"], got["false"]
    assert sp["temp_size_in_bytes"] < full["temp_size_in_bytes"]
    assert sp["argument_size_in_bytes"] == full["argument_size_in_bytes"]
    assert sp["output_size_in_bytes"] == full["output_size_in_bytes"]


# a tensor-parallel MoE at groups of 8 rows (4 a rank: gathered first),
# an expert-parallel one with shared experts at groups of 1 row
MOE_CASES = (("mixtral-8x22b", 16), ("deepseek-v2-lite-16b", 64))


def _moe_inputs(arch, S):
    from repro_torch.models import moe
    cfg = get_arch(arch).smoke.with_(dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(S)
    p = {k: torch.from_numpy(0.1 * rng.standard_normal(s, dtype=np.float32))
         for k, s in moe.param_shapes(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((8, S, cfg.d_model),
                                             dtype=np.float32))
    return cfg, p, x


def _moe_results(cfg, p, x):
    """(y, aux, counts, parameter gradients) of one ``moe_block`` call,
    each whole on the host."""
    from repro_torch.models import moe
    p = {k: t.requires_grad_() for k, t in p.items()}
    y, aux, counts = moe.moe_block(p, cfg, x)
    ((y * y).sum() + aux).backward()

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t
                ).detach().numpy()
    return (whole(y), float(whole(aux)), whole(counts),
            {k: whole(t.grad) for k, t in p.items()})


def _moe_rank(rank):
    """``moe_block`` on a (2, 2) mesh: parameters placed by
    ``PARAM_RULES``, x batch-sharded, under the activation rules."""
    _background()
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import (activation_sharding, distribute,
                                      distribute_tree, sharding_for,
                                      tree_shardings)
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch, S in MOE_CASES:
        cfg, p, x = _moe_inputs(arch, S)
        axes = param_axes(cfg)
        sh = tree_shardings(p, {k: axes[f"blocks.0.moe.{k}"] for k in p},
                            rules_for(cfg), mesh)
        act = rules_for(cfg, param=False)
        dx = distribute(x, sharding_for(x.shape, ("batch", "seq",
                                                  "act_embed"), act, mesh))
        with activation_sharding(mesh, act):
            out[arch, S] = _moe_results(cfg, distribute_tree(p, sh), dx)
    return out


def test_sharded_moe_block_equals_the_unsharded_block():
    """``moe_block`` on DTensors (one body with the unsharded block: the
    routing, dispatch and combine on each rank's rows) on 4 gloo ranks:
    the output and every parameter gradient within 1e-5 of scale of the
    unsharded block's, the aux loss within 1e-6 relative, the expert
    counts equal, for an expert-parallel and a tensor-parallel MoE, with
    a rank's rows holding whole groups and with the groups gathered."""
    want = {(arch, S): _moe_results(*_moe_inputs(arch, S))
            for arch, S in MOE_CASES}
    for got in run_ranks(_moe_rank, 4):
        assert set(got) == set(want)
        for key, (y, aux, counts, grads) in want.items():
            gy, gaux, gcounts, ggrads = got[key]
            assert np.abs(gy - y).max() <= 1e-5 * np.abs(y).max(), key
            assert abs(gaux - aux) <= 1e-6 * abs(aux), key
            np.testing.assert_array_equal(gcounts, counts)
            for k, g in grads.items():
                assert np.abs(ggrads[k] - g).max() <= \
                    1e-5 * np.abs(g).max(), (key, k)


# -- (g) re-mesh -------------------------------------------------------------

def _remesh_rank(rank, ckpt, ref_ckpt):
    """Save under (2, 2), restore under (4, 1); restore the reference's
    checkpoint under (4, 1) too."""
    _background()
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import family_module
    from repro_torch.models.convert import params_to_tree
    from repro_torch.train import checkpoint, remesh
    cfg = _smoke()
    model = family_module(cfg).init(cfg, 0, "cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    tree = params_to_tree(params, cfg)
    from repro_torch.train.loop import shard_train_state
    from repro_torch.optim import init_opt_state
    a = make_mesh((2, 2), ("data", "model"))
    sharded, _ = shard_train_state(cfg, params, init_opt_state(params), a)
    checkpoint.save(ckpt, 5, {"params": params_to_tree(sharded, cfg)})
    torch.distributed.destroy_process_group()
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{ckpt}.store", rank=rank,
        world_size=4)
    b = make_mesh((4, 1), ("data", "model"))
    templates = {"params": {k: v for k, v in tree.items()}}
    step, out = remesh(ckpt, cfg, templates, b, axes_tree=axes_tree(cfg))
    leaf = out["params"]["embed"]["tokens"]
    placed = (tuple(leaf.device_mesh.shape), str(leaf.placements))

    def full(node):
        if isinstance(node, dict):
            return {k: full(v) for k, v in node.items()}
        return node.full_tensor().numpy()
    ref_step, ref_out = remesh(ref_ckpt, cfg, templates, b,
                               axes_tree=axes_tree(cfg))
    return step, placed, full(out["params"]), ref_step, full(
        ref_out["params"])


def test_remesh_from_2x2_to_4x1_and_from_the_reference():
    """(g) Parameters saved as DTensors under (2, 2) are written whole and
    restore under (4, 1) as DTensors with every leaf equal; a checkpoint
    the reference saved restores under a port mesh too."""
    import jax
    from repro.configs import get_arch as ref_arch
    from repro.models import build
    from repro.train import checkpoint as ref_ckpt
    from repro_torch.models import family_module
    from repro_torch.models.convert import params_to_numpy
    cfg = _smoke()
    model = family_module(cfg).init(cfg, 0, "cpu")
    want = params_to_numpy({k: p.detach()
                            for k, p in model.named_parameters()}, cfg)
    ref_params, _ = build(ref_arch("st-100m").smoke.with_(
        dtype="float32", param_dtype="float32")).init(jax.random.key(3))
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(f"{d}/ref", 2, {"params": ref_params})
        results = run_ranks(_remesh_rank, 4, args=(f"{d}/ours", f"{d}/ref"))
    ref_flat = jax.tree.map(np.asarray, ref_params)
    for step, placed, got, ref_step, ref_got in results:
        assert step == 5 and ref_step == 2
        assert placed[0] == (4, 1) and "Shard(dim=1)" in placed[1]
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(ref_got), jax.tree.leaves(ref_flat)):
            np.testing.assert_array_equal(a, b)


def test_remesh_without_a_mesh_restores_host_tensors(tmp_path):
    from repro_torch.models import family_module
    from repro_torch.models.convert import params_to_tree
    from repro_torch.train import checkpoint, remesh
    cfg = _smoke()
    model = family_module(cfg).init(cfg, 0, "cpu")
    tree = params_to_tree({k: p.detach()
                           for k, p in model.named_parameters()}, cfg)
    checkpoint.save(str(tmp_path), 1, {"params": tree})
    step, out = remesh(str(tmp_path), cfg, {"params": tree})
    assert step == 1
    assert torch.equal(out["params"]["embed"]["tokens"],
                       tree["embed"]["tokens"])


def test_trainer_stores_its_mesh_and_uses_it_nowhere():
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = _smoke()
    marker = object()
    t = Trainer(cfg, AdamWConfig(), DataConfig(seq_len=16, global_batch=2,
                                               vocab=cfg.vocab),
                TrainerConfig(steps=1), device="cpu", mesh=marker)
    assert t.mesh is marker
    assert t.run(1)[0]["step"] == 0


_CKPT_RUNS = r"""
import sys
from repro_torch.launch.train import main
base = ["--arch", "st-100m", "--smoke", "--batch", "2", "--seq", "32",
        "--device", "cpu", "--ckpt-every", "2"]
for name, mesh in (("sharded", ["--mesh", "1x1"]), ("plain", [])):
    for steps in ("3", "1"):
        main(base + mesh + ["--steps", steps,
                            "--ckpt-dir", f"{sys.argv[1]}/{name}"])
"""


def test_sharded_launch_saves_and_resumes_as_the_unsharded_one(tmp_path):
    """``launch.train --mesh 1x1`` over gloo with ``--ckpt-dir``: 3 steps
    then 1 resumed step write the unsharded run's checkpoint steps, hold
    its parameters within 1e-5 of scale and give its losses within 1e-5
    relative."""
    from repro_torch.launch.train import build_trainer, parser
    from repro_torch.train import checkpoint
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([*NICE, sys.executable, "-c", _CKPT_RUNS,
                        str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert lines.count("resumed from step 3") == 2, p.stdout[-3000:]
    sharded_a, sharded_b, plain_a, plain_b = [
        json.loads(l) for l in lines if l.startswith("{")]
    for got, want in ((sharded_a, plain_a), (sharded_b, plain_b)):
        assert got["steps"] == want["steps"]
        assert abs(got["final_loss"] - want["final_loss"]) <= \
            1e-5 * abs(want["final_loss"])
    assert sharded_b["steps"] == 4
    steps = sorted(os.listdir(tmp_path / "plain"))
    assert steps == ["step_0000000002", "step_0000000003",
                     "step_0000000004"]
    assert sorted(os.listdir(tmp_path / "sharded")) == steps
    templates = build_trainer(parser().parse_args(
        ["--arch", "st-100m", "--smoke", "--device", "cpu"])
    ).checkpoint_templates()
    (step, want), (got_step, got) = [
        checkpoint.restore(str(tmp_path / name), templates)
        for name in ("plain", "sharded")]
    assert step == got_step == 4
    for name in ("params", "opt_state"):
        for (key, w), (gkey, g) in zip(checkpoint._leaves(want[name]),
                                       checkpoint._leaves(got[name])):
            assert key == gkey
            w, g = w.double(), g.double()
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= 1e-5 * scale, key


_PHASE_32 = r"""
import json
import chip_smoke as cs
res = cs.multi_device_phase(
    "cpu", argv=("--arch", "st-100m", "--steps", "2", "--batch", "2",
                 "--seq", "32"),
    cells=(("gemma-7b", "decode_32k", False),), smoke=True)
print("RESULT" + json.dumps(res, default=str))
"""


def test_chip_smoke_multi_device_phase_rehearsed():
    """chip_smoke's phase 32 on the host at a small size: the smoke config
    through ``launch.train --mesh 1x1`` over gloo against the unsharded
    trainer, the compressed all-reduce in a one-rank gloo group, one
    dry-run cell, the SP planning cells and the triage example on two
    lanes, each in a child (the phase itself runs in one, below this
    process's priority)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    res = _result(_PHASE_32, "")
    assert len(res["sharded"]["losses"]) == 2
    assert res["sharded"]["losses"] == pytest.approx(
        res["plain"]["losses"], rel=cs.SHARDED_TOL)
    c = res["compression"]
    assert c["summary"] == (f"all-reduce: n={2 * c['leaves']} "
                            f"bytes={c['allreduce_bytes']:,}")
    assert res["cells"]["gemma-7b/decode_32k"]["ok"]
    assert any(l.startswith("CCR") for l in res["triage"])
    sp, no_sp = res["sp_planning"]["sp"], res["sp_planning"]["no_sp"]
    assert sp["sp"] and not no_sp["sp"]
    assert sp["memory"]["temp_size_in_bytes"] < \
        no_sp["memory"]["temp_size_in_bytes"]


_OWN_FAKE = r"""
import sys
sys.modules["torch.testing._internal.distributed.fake_pg"] = None
import torch.distributed as dist
from repro_torch.launch.mesh import fake_world, make_mesh
fake_world(4)
mesh = make_mesh((2, 2), ("data", "model"))
assert dist.get_backend() == "fake" and tuple(mesh.shape) == (2, 2)
print("OK")
"""


def test_fake_world_registers_its_own_backend_without_the_testing_package():
    """Where PyTorch's testing package is missing, ``fake_world`` registers
    the C++ fake process group itself; a world too small for a mesh
    raises with the way to launch one."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([*NICE, sys.executable, "-c", _OWN_FAKE],
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 0 and "OK" in p.stdout, p.stderr[-2000:]
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="needs 512 ranks.*fake_world"):
        make_production_mesh(multi_pod=True)
