"""``remat_policy`` in the port (``models/transformer.py::remat``), the twin
of the reference's ``_maybe_remat``.

For every family's smoke config (dense, MoE, MLA, vlm, ssm, hybrid with a
tail, encdec) and each policy: the loss and every gradient equal those
under "full" bit for bit on the CPU (the recompute runs the same float32
operations in the same order); each block the reference wraps (a
decoder-only model's layers, a hybrid's pattern groups, an encdec's
encoder and decoder layers) runs its forward twice in a training step and
the hybrid's tail once, and every block runs once in ``decode_step``; the
bytes kept for the backward fall from "full" to "dots" to "nothing"; an
unknown policy string behaves as "nothing", as in the reference.  The
kept bytes are those of the storages that the forward's operations made
and that are still alive when the loss is returned (a
``saved_tensors_hooks`` count sees only the tensors saved outside the
checkpointed blocks: inside them the checkpoint's own hooks take over).
chip_smoke.py's launch accounting of the recompute and its phases 27 and
28 (C and D) are rehearsed at a small size on the host.
"""
import gc
import importlib.util
import pathlib
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_arch
from repro_torch.data import batch_for_model
from repro_torch.models import family_module
from repro_torch.train.loop import value_and_grad

ROOT = pathlib.Path(__file__).resolve().parents[1]
# One smoke config a family (the hybrid's cut to one pattern group and a
# (rec, rec) tail).
FAMILIES = {"dense": ("st-100m", {}), "moe": ("mixtral-8x22b", {}),
            "mla": ("deepseek-v2-lite-16b", {}),
            "vlm": ("phi-3-vision-4.2b", {}), "ssm": ("rwkv6-3b", {}),
            "hybrid": ("recurrentgemma-9b", {"n_layers": 5}),
            "encdec": ("seamless-m4t-medium", {})}
POLICIES = ("nothing", "dots", "no-such-policy")


def _cfg(family, policy="nothing"):
    arch, over = FAMILIES[family]
    return get_arch(arch).smoke.with_(remat_policy=policy, **over)


def _setup(family, policy="nothing"):
    """(cfg, a meta skeleton, seeded weights as leaves' sources, batch)."""
    cfg = _cfg(family, policy)
    mod = family_module(cfg)
    params = {k: p.detach() for k, p in mod.init(cfg, 0, "cpu")
              .named_parameters()}
    batch = batch_for_model(cfg, SHAPES["train_4k"], batch_override=2,
                            seq_override=16, device="cpu")
    return cfg, mod.init(cfg, None, "meta"), params, batch


def _blocks(model):
    """{name: module} of the blocks the reference wraps, and the tail."""
    if hasattr(model, "enc_layers"):
        return {**{f"enc{i}": m for i, m in enumerate(model.enc_layers)},
                **{f"dec{i}": m for i, m in enumerate(model.dec_layers)}}
    out = {f"block{i}": m for i, m in enumerate(model.blocks)}
    if getattr(model, "tail", None) is not None:
        out["tail"] = model.tail
    return out


def _count_calls(model) -> dict:
    """Forward calls of each block, counted by pre-hooks (a recompute may
    stop after the block's last saved tensor, before its forward
    returns)."""
    counts = {}
    for name, m in _blocks(model).items():
        counts[name] = 0

        def hook(mod, args, name=name):
            counts[name] += 1
        m.register_forward_pre_hook(hook)
    return counts


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_policy_gives_the_full_gradients(family, policy):
    _, full, params, batch = _setup(family, "full")
    want_loss, want_info, want = value_and_grad(full, params, batch)
    _, skeleton, _, _ = _setup(family, policy)
    loss, info, got = value_and_grad(skeleton, params, batch)
    assert torch.equal(loss, want_loss)
    assert sorted(info) == sorted(want_info)
    for k in want_info:
        assert torch.equal(info[k], want_info[k]), k
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_blocks_recompute_as_the_reference_wraps_them(family):
    """Twice a training step under "nothing", "dots" and an unknown
    policy, once under "full"; the hybrid's tail once; every block once
    in decode_step (an encdec's encoder layers not at all there)."""
    for policy, twice in (("full", False), *((p, True) for p in POLICIES)):
        _, skeleton, params, batch = _setup(family, policy)
        counts = _count_calls(skeleton)
        value_and_grad(skeleton, params, batch)
        for name, n in counts.items():
            assert n == (2 if twice and name != "tail" else 1), \
                (policy, name, n)
    cfg = _cfg(family)
    model = family_module(cfg).init(cfg, 0, "cpu")
    if cfg.family == "encdec":
        with torch.no_grad():
            enc = model.encode(batch["embeds"][:1])
        state = model.init_decode_state(1, 8, enc_out=enc)
    else:
        state = model.init_decode_state(1, 8)
    counts = _count_calls(model)
    model.decode_step(state, torch.zeros((1, 1), dtype=torch.int32), 0)
    assert counts == {name: 0 if name.startswith("enc") else 1
                      for name in counts}


class _LiveStorages(TorchDispatchMode):
    """Weak references to the storage of every operation's output."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t.untyped_storage()))
        return out

    def live_bytes(self) -> int:
        gc.collect()
        alive = {}
        for ref in self.refs:
            st = ref()
            if st is not None:
                alive[st.data_ptr()] = st.nbytes()
        return sum(alive.values())


def _kept_bytes(family, policy) -> int:
    cfg, _, _, batch = _setup(family, policy)
    model = family_module(cfg).init(cfg, 0, "cpu").requires_grad_()
    mode = _LiveStorages()
    with mode:
        total, _ = family_module(cfg).loss_fn(model, None, batch)
    kept = mode.live_bytes()
    torch.autograd.grad(total, list(model.parameters()))
    return kept


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kept_bytes_fall_with_the_policy(family):
    kept = {p: _kept_bytes(family, p)
            for p in ("full", "dots", "nothing", "no-such-policy")}
    assert kept["nothing"] < kept["dots"] < kept["full"], kept
    assert kept["no-such-policy"] == kept["nothing"]


def test_no_recompute_without_a_gradient():
    """Under no_grad, or with nothing that requires a gradient, a block
    runs once whatever the policy."""
    cfg, skeleton, params, batch = _setup("ssm")
    counts = _count_calls(skeleton)
    fam = family_module(cfg)
    with torch.no_grad():
        fam.loss_fn(skeleton, params, batch)
    fam.loss_fn(skeleton, params, batch)
    assert set(counts.values()) == {2}


# -- chip_smoke's launch accounting and phases 27 and 28, rehearsed -------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_recompute_per_step_counts_the_wrapped_blocks():
    cs = _chip_smoke()
    full = {a: get_arch(a).full for a in ("st-100m", "rwkv6-3b",
                                          "recurrentgemma-9b",
                                          "seamless-m4t-medium")}
    assert cs.recompute_per_step(full["st-100m"]) == {
        "rmsnorm": 24, "flash_attention": 12}
    assert cs.recompute_per_step(full["rwkv6-3b"]) == {"rmsnorm": 64,
                                                       "wkv6": 32}
    # 38 layers: 12 (rec, rec, attn) groups recomputed, a (rec, rec) tail
    # not
    assert cs.recompute_per_step(full["recurrentgemma-9b"]) == {
        "rmsnorm": 72, "flash_attention": 12}
    e = full["seamless-m4t-medium"]
    assert cs.recompute_per_step(e) == {
        "rmsnorm": 3 * e.n_layers + 2 * e.n_encoder_layers,
        "flash_attention": 2 * e.n_layers + e.n_encoder_layers}
    for cfg in full.values():
        assert cs.recompute_per_step(cfg.with_(remat_policy="full")) == {}


def test_chip_smoke_rwkv_training_phase_rehearsed():
    cs = _chip_smoke()
    t = cs.train_phase(("--arch", "rwkv6-3b", "--smoke", "--steps", "20",
                        "--batch", "8", "--seq", "32"), "cpu")
    assert t["steps"] == 20 and t["breakdown"] is None
    assert t["ranges"] is None
    step = {"busy_ms": 100.0, "ported_ms": {"wkv6": 2.0}}
    ranges = {"busy_ms": 80.0,
              "ranges": {"wkv6_backward": {"calls": 32, "device_ms": 40.0}}}
    sh = cs.wkv6_shares(step, ranges, 32)
    assert sh["forward_share"] == 0.02 and sh["backward_share"] == 0.5
    for calls, ms in ((31, 40.0), (32, 0.0)):
        ranges["ranges"]["wkv6_backward"] = {"calls": calls,
                                             "device_ms": ms}
        with pytest.raises(AssertionError, match="wkv6_backward"):
            cs.wkv6_shares(step, ranges, 32)


@pytest.mark.parametrize("arch", ["st-100m", "rwkv6-3b"])
def test_chip_smoke_remat_phase_rehearsed(arch):
    cs = _chip_smoke()
    r = cs.remat_phase(get_arch(arch).smoke, "cpu", 2, 16, 3)
    assert list(r) == list(cs.REMAT_POLICIES)
    for pol in cs.REMAT_POLICIES:
        assert r[pol]["losses"] == r["full"]["losses"]
        assert r[pol]["peak_memory_bytes"] is None
        assert len(r[pol]["step_s"]) == 2
