"""The static-buffer decode path of ``TorchBackend`` against the reference.

On the card ``TorchBackend`` replays one CUDA graph per (lane, call shape)
(``serve/runtime.py``).  A graph reads the addresses it was captured
with, so every decode state must be written in place, keep its tensors
and read its cache index from the device.  On the CPU the backend goes
through the same lane states and static inputs and calls the model on
them, which these tests hold, on width cuts (the smoke configs) of the
six served families with seeded numpy inputs:

(a) across a chunk call and several one-token calls every tensor of a
    lane's decode state keeps its ``data_ptr()`` and no entry is rebound;
    a new request resets the same tensors to ``init_decode_state``'s
    values;
(b) the device ``idx`` and the slots written equal the reference's
    ``init_decode_state`` and jitted ``decode_step``, through a window's
    ring wrap and a chunk clamped at the window's end, and
    ``cache_write_slot`` on a device index lands where the reference's
    ``lax.dynamic_update_slice_in_dim`` does;
(c) served tokens equal ``JitBackend``'s with lanes interleaved and a
    prompt whose last chunk is shorter, a shape first seen after warmup;
(d) a lane reused by a second request gives a fresh backend's tokens.

Logits tolerance as in ``test_torch_models.py``: 1e-5 of the reference's
scale (float32 sums in another order); slots, positions and indices
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_arch as ref_arch
from repro.models import build as ref_build
from repro.scenarios import traffic as ref_traffic
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.runtime import JitBackend
from repro_torch.configs import get_arch
from repro_torch.models import build, layers, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.scenarios import traffic
from repro_torch.serve import ServeConfig, ServeEngine, TorchBackend
from repro_torch.serve.runtime import state_tensors

FAMILIES = ("gemma-7b", "rwkv6-3b", "deepseek-v2-lite-16b",
            "phi-3-vision-4.2b", "recurrentgemma-9b", "seamless-m4t-medium")
CHUNK_FAMILIES = ("gemma-7b", "deepseek-v2-lite-16b", "phi-3-vision-4.2b")
LOGIT_RTOL = 1e-5


def _frames(cfg, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(131 + seed)
                            .standard_normal((1, cfg.frontend_tokens,
                                              cfg.d_model))
                            .astype(np.float32))


def _backend(arch, lanes=1, prompt=12, gen=6, seed=0):
    """A CPU TorchBackend on the arch's smoke config with weights drawn
    from ``seed``, warmed up: chunks of 4 where the family takes chunks."""
    cfg = get_arch(arch).smoke
    api = build(cfg, "cpu")
    chunk = 4 if arch in CHUNK_FAMILIES else 1
    b = TorchBackend(cfg, api, api.init(seed), lanes=lanes,
                     max_len=prompt + gen + 1, prefill_chunk=chunk,
                     embeds_fn=lambda req: _frames(cfg, req.rid))
    b.warmup()
    return b


def _addresses(state, path=""):
    """{path: (id, data_ptr)} of every tensor of a decode state."""
    if isinstance(state, torch.Tensor):
        return {path: (id(state), state.data_ptr())}
    items = state.items() if isinstance(state, dict) else enumerate(state)
    out = {}
    for key, item in items:
        out.update(_addresses(item, f"{path}/{key}"))
    return out


def _greedy(b, lane, prompt: np.ndarray, gen: int, frames=None):
    """A request on ``lane``: its state reset (an encdec's from
    ``frames``), the prompt in the backend's chunks, then ``gen`` greedy
    tokens, each fed back.  Returns the tokens."""
    b.fresh_state(frames, lane=lane)
    chunk, P = b.prefill_chunk, prompt.shape[1]
    for a in range(0, P, chunk):
        logits = b.model_call(lane, prompt[:, a:a + chunk], a)
    tokens = []
    for g in range(gen):
        tok = b._sample(logits)
        tokens.append(int(tok[0, 0]))
        logits = b.model_call(lane, tok, P + g)
    return tokens


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, n),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_state_keeps_its_tensors_across_calls(arch):
    """(a) A chunk call (or one token, for the families without chunks),
    then one-token calls: the lane's state keeps every tensor object and
    its storage, its entries unbound; it did change; a reset gives the
    same tensors back holding a new state's values."""
    b = _backend(arch)
    cfg = b.cfg
    frames = _frames(cfg, 3) if cfg.family == "encdec" else None
    state = b.fresh_state(frames, lane=0)
    before = _addresses(state)
    first = [t.clone() for t in state_tensors(state)]
    tokens = _greedy(b, 0, _prompt(cfg, 12, 5), 4, frames)
    assert b._state[0] is state and _addresses(state) == before
    assert len(tokens) == 4
    changed = [not torch.equal(t, t0)
               for t, t0 in zip(state_tensors(state), first)]
    assert any(changed)
    if cfg.family != "ssm":
        idx = [t for p, t in zip(before, state_tensors(state))
               if p.endswith("/idx")]
        assert idx and all(t.dtype == torch.int32 and t.dim() == 0
                           and int(t) == 12 + 4 for t in idx)
    b.fresh_state(frames, lane=0)
    assert _addresses(state) == before
    new = b.fresh_state(frames)
    for t, t0 in zip(state_tensors(state), state_tensors(new)):
        assert torch.equal(t, t0)
    assert _addresses(b._state[0]) == before


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "deepseek-v2-lite-16b"])
def test_device_index_and_slots_match_reference(arch):
    """(b) A 20-token prompt in chunks of 8 (the last of 4 tokens), then 6
    one-token calls, through the backend's lane on the CPU and through the
    reference's jitted ``decode_step``.  danube's 16-slot window cache:
    the third chunk is clamped to slots 12..15 (its index is 16) and the
    decode calls wrap the ring from slot 4; deepseek's MLA latent cache
    is written at ``idx`` with no ring.  After every call the index is an
    int32 scalar on the state's device equal to the reference's, and the
    positions and cache entries equal the reference's."""
    rcfg, cfg = ref_arch(arch).smoke, get_arch(arch).smoke
    api = ref_build(rcfg)
    params, _ = api.init(jax.random.key(0))
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    P, gen, chunk = 20, 6, 8
    max_len = P + gen + 1
    b = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=1,
                     max_len=max_len, prefill_chunk=chunk)
    b.warmup()
    state = b.fresh_state(lane=0)
    step = jax.jit(api.decode_step)
    st_r = api.init_decode_state(1, max_len)
    prompt = _prompt(cfg, P, 9)
    names = ("k", "v", "pos") if cfg.mla is None else ("c_kv", "k_rope")
    calls = [(prompt[:, a:a + chunk], a) for a in range(0, P, chunk)]
    for i in range(len(calls) + gen):
        if i < len(calls):
            toks, a = calls[i]
            pos = jnp.arange(a, a + toks.shape[1], dtype=jnp.int32) \
                if toks.shape[1] > 1 else jnp.int32(a)
        else:
            toks, a = np.array([[tok]], np.int32), P + i - len(calls)
            pos = jnp.int32(a)
        lr, st_r = step(params, st_r, jnp.asarray(toks), pos)
        lt = b.model_call(0, toks, a)
        want = np.asarray(lr)
        assert np.abs(lt.numpy() - want).max() <= \
            LOGIT_RTOL * np.abs(want).max()
        tok = int(np.argmax(want[0, -1]))
        assert int(lt[0, -1].argmax()) == tok
        for j, cache in enumerate(state["layers"]):
            idx = cache["idx"]
            assert idx.dim() == 0 and idx.dtype == torch.int32
            assert idx.device == b.device
            assert int(idx) == int(st_r["layers"]["idx"][j]) == a + \
                toks.shape[1]
            for name in names:
                got = cache[name].numpy()
                ref = np.asarray(st_r["layers"][name][j])
                if name == "pos":
                    np.testing.assert_array_equal(got, ref)
                else:
                    np.testing.assert_allclose(got, ref, atol=1e-5,
                                               rtol=1e-5)
    if cfg.window is not None:
        # the clamped chunk put positions 16..19 in slots 12..15, over
        # 12..15; the ring then put 20..25 in slots 4..9, over 4..9
        np.testing.assert_array_equal(
            state["layers"][0]["pos"].numpy(),
            np.r_[np.arange(0, 4), np.arange(20, 26), np.arange(10, 12),
                  np.arange(16, 20)])


def test_cache_write_slot_on_the_device_matches_the_reference():
    """The slot of a device ``idx`` (0-d int32) equals the host rule's and
    the slot the reference's ``lax.dynamic_update_slice_in_dim`` writes
    (at ``idx % max_len`` for one token, at ``idx`` clamped into [0,
    max_len - S] for a chunk), for every index up to three rings; MLA's
    write (no ring) clamps the same way."""
    def landed(idx, S, max_len, ring):
        write = idx % max_len if S == 1 and ring else idx
        buf = lax.dynamic_update_slice_in_dim(
            jnp.zeros(max_len, jnp.int32), jnp.ones(S, jnp.int32),
            jnp.int32(write), 0)
        return int(np.argmax(np.asarray(buf)))
    for max_len in (16, 7):
        for S in sorted({1, 4, max_len}):
            for ring in (True, False):
                for idx in range(3 * max_len + 2):
                    got = layers.cache_write_slot(
                        torch.tensor(idx, dtype=torch.int32), S, max_len,
                        ring)
                    assert got.dtype == torch.int32 and got.dim() == 0
                    want = landed(idx, S, max_len, ring)
                    assert int(got) == want == layers.cache_write_slot(
                        idx, S, max_len, ring), (idx, S, max_len, ring)
    with pytest.raises(ValueError, match="does not fit"):
        layers.cache_write_slot(torch.tensor(0, dtype=torch.int32), 17, 16)


@pytest.mark.parametrize("arch", CHUNK_FAMILIES)
def test_static_path_serves_the_jit_backend_tokens(arch):
    """(c) Two lanes, four requests of 14-token prompts in chunks of 4
    (the last of 2: a (1, 2) call, first seen after warmup), 4 tokens
    each: the port's tokens equal the reference's on the same weights,
    and each lane kept one state and one static call a shape."""
    rcfg, cfg = ref_arch(arch).smoke, get_arch(arch).smoke
    api = ref_build(rcfg)
    params, _ = api.init(jax.random.key(1))
    model = transformer.Transformer(cfg, "cpu", seed=None)
    model.load_state_dict(params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    tkw = dict(n_requests=4, arrival_rate=2.0, length_buckets=(14,),
               length_mix=(1.0,), gen_len=4, vocab=cfg.vocab)
    max_len, lanes, chunk = 14 + 4 + 1, 2, 4
    ref_b = JitBackend(rcfg, api, params, lanes=lanes, max_len=max_len,
                       prefill_chunk=chunk)
    RefServeEngine(RefServeConfig(lanes=lanes, max_len=max_len,
                                  prefill_chunk=chunk),
                   ref_traffic.generate_traffic(
                       ref_traffic.TrafficConfig(**tkw), 0), ref_b).run()
    b = TorchBackend(cfg, build(cfg, "cpu"), model, lanes=lanes,
                     max_len=max_len, prefill_chunk=chunk)
    states = [_addresses(s) for s in b._state]
    e = ServeEngine(ServeConfig(lanes=lanes, max_len=max_len,
                                prefill_chunk=chunk),
                    traffic.generate_traffic(traffic.TrafficConfig(**tkw),
                                             0), b)
    e.run()
    assert b.outputs == ref_b.outputs and len(b.outputs) == 4
    assert [_addresses(s) for s in b._state] == states
    assert sorted(b._calls) == [(lane, k) for lane in range(lanes)
                                for k in (1, 2, 4)]
    # warmup's eager call per steady-state shape, then one call a chunk
    # and a decoded token
    assert b.model_calls == 2 + 4 * 4 + e.tokens_decode


@pytest.mark.parametrize("arch", FAMILIES)
def test_reused_lane_gives_a_fresh_backends_tokens(arch):
    """(d) A lane that served one request, then another (another prompt;
    for encdec other frames), generates for the second what a fresh
    backend's lane generates for it, token for token."""
    b = _backend(arch)
    cfg = b.cfg
    enc = cfg.family == "encdec"
    first = _greedy(b, 0, _prompt(cfg, 12, 21), 6,
                    _frames(cfg, 1) if enc else None)
    second = _greedy(b, 0, _prompt(cfg, 12, 22), 6,
                     _frames(cfg, 2) if enc else None)
    fresh = _greedy(_backend(arch), 0, _prompt(cfg, 12, 22), 6,
                    _frames(cfg, 2) if enc else None)
    assert second == fresh and len(first) == 6
