"""The int8 compressed all-reduce (``repro_torch.optim.compression``)
against the reference's (``repro.optim.compression``) on the same inputs:
the codes bit for bit, the 2-pod mean over ``gloo`` equal to the
reference's shard_map mean on 8 fake devices, and the int32 payload that
``core.hlo.collectives_of`` counts."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks
from repro_torch.optim import (compressed_psum_fn, dequantize_int8,
                               pod_compressed_allreduce, quantize_int8,
                               quantize_tree)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# Children of these tests (reference compiles, gloo ranks) run below the
# test process's priority, so they take only the CPU that the
# timing-gated tests running beside them in a parallel run leave.
NICE = ("nice", "-n", "10")


def _background():
    os.nice(10)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 33)).astype(np.float32) * 3.0
    # exact halves of a code, where round-half-to-even decides
    scale = np.float32(np.abs(x).max()) / np.float32(127.0)
    x[0, :8] = (np.arange(8, dtype=np.float32) + np.float32(0.5)) * scale
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_is_bit_equal_to_the_references(seed):
    import jax.numpy as jnp
    from repro.optim import compression as ref
    x = _inputs(seed)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    assert s.item() == float(rs)
    np.testing.assert_array_equal(
        dequantize_int8(q, s).numpy(),
        np.asarray(ref.dequantize_int8(rq, rs)))
    qt, st = quantize_tree({"a": torch.from_numpy(x), "b": torch.ones(3)})
    assert set(qt) == set(st) == {"a", "b"}
    assert torch.equal(qt["a"], q)


def test_zero_tensor_quantizes_to_zero_codes():
    q, s = quantize_int8(torch.zeros(5))
    assert torch.equal(q, torch.zeros(5, dtype=torch.int8))
    assert s.item() == pytest.approx(1e-30 / 127.0)


_REF_POD = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.optim import pod_compressed_allreduce
mesh = make_mesh((2, 4), ("pod", "data"))
g = jnp.asarray(np.asarray(json.loads(sys.argv[1]), dtype=np.float32))
arr = jax.device_put(g, NamedSharding(mesh, P("pod")))
out = pod_compressed_allreduce(mesh, {"w": arr}, axis="pod")
print("RESULT" + json.dumps(np.asarray(out["w"]).tolist()))
"""


def _pod_rank(rank, stacked):
    _background()
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.hlo import collectives_of
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
    g = {"w": torch.tensor(stacked, dtype=torch.float32)}
    out = pod_compressed_allreduce(mesh, g, axis="pod")["w"]
    stats = collectives_of(lambda: compressed_psum_fn({"w": g["w"][rank]}))
    return out.numpy(), stats.bytes_by_op, stats.count_by_op


def test_two_pod_mean_equals_the_references():
    """(d) Pod 0 computed 1.0s and pod 1 3.0s: the mean is within 0.05 of
    2.0; on a random stacked input the port's 2-rank gloo mean equals the
    reference's shard_map mean on a (2, 4) mesh bit for bit; the payload
    is the int32 codes (4 bytes an element) and the amax."""
    rng = np.random.default_rng(7)
    cases = [np.stack([np.full(4, 1.0), np.full(4, 3.0)]).astype(np.float32),
             rng.standard_normal((2, 96)).astype(np.float32)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    for i, stacked in enumerate(cases):
        p = subprocess.run([*NICE, sys.executable, "-c", _REF_POD,
                            json.dumps(stacked.tolist())],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        line = [l for l in p.stdout.splitlines()
                if l.startswith("RESULT")][-1]
        want = np.asarray(json.loads(line[len("RESULT"):]),
                          dtype=np.float32)
        for out, nbytes, counts in run_ranks(_pod_rank, 2,
                                             args=(stacked.tolist(),)):
            assert out.shape == stacked.shape[1:]
            np.testing.assert_array_equal(out, want)
            if i == 0:
                assert np.all(np.abs(out - 2.0) < 0.05), out
            n = stacked.shape[1]
            assert nbytes == {"all-reduce": 4 * n + 4}
            assert counts == {"all-reduce": 2}


def test_mesh_without_the_axis_returns_the_first_row():
    import types
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    g = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(pod_compressed_allreduce(mesh, {"w": g})["w"], g[0])
