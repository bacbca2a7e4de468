"""The port's ring collective matmul and compressed cross-pod reduction
against the JAX package's, on the same numpy inputs.

JAX's ``ring_allgather_matmul`` (model axes of 4, 2 and 1 devices) and
``crosspod_psum_compressed`` (a ("pod", "data") mesh of 4 pods) run once in
one subprocess with 4 emulated host devices, as ``tests/test_distributed.py``
runs them; the port runs once over 4 gloo ranks spawned locally and joined
through a file store (``tests/_torch_collective_workers.py``), both while
the other runs.  The ring is held within 2e-5 (JAX's own tolerance); the
reduction's int8 payload, scale and carried error bit for bit, and its
float32 sum within 1e-6 of its max.
"""
import multiprocessing
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.optim.grad_compress import (compress_with_feedback,
                                             crosspod_psum_compressed,
                                             dequantize_int8)
from repro_torch.sharding import (ring_allgather_matmul,
                                  ring_allgather_matmul_local)

sys.path.insert(0, str(Path(__file__).parent))
import _torch_collective_workers as workers  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SEED = 39
WORLD = 4
RING_TOL = 2e-5
REDUCED_REL = 1e-6
SPAWN_TIMEOUT_S = 120

JAX_RUN = textwrap.dedent("""\
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.optim.grad_compress import (compress_with_feedback,
                                           crosspod_psum_compressed)
    from repro.sharding.collective_matmul import ring_allgather_matmul

    d = sys.argv[1]
    inp = np.load(d + "/inputs.npz")
    x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])
    out, devs = {}, jax.devices()
    for n in (4, 2, 1):
        mesh = Mesh(np.array(devs[:n]), ("model",))
        with mesh:
            out[f"ring{n}"] = np.asarray(
                ring_allgather_matmul(x, w, mesh, axis="model"))

    def body(g, e):
        q, scale, _ = compress_with_feedback(g, e)
        reduced, new_error = crosspod_psum_compressed(g, e, axis="pod")
        return q, scale[None], reduced, new_error

    mesh = Mesh(np.array(devs[:4]).reshape(4, 1), ("pod", "data"))
    f = shard_map(body, mesh=mesh, in_specs=(P("pod", None), P("pod", None)),
                  out_specs=(P("pod", None), P("pod"), P("pod", None),
                             P("pod", None)), check_rep=False)
    with mesh:
        q, scale, reduced, new_error = f(jnp.asarray(inp["g"]),
                                         jnp.asarray(inp["e"]))
    out.update(q=np.asarray(q), scale=np.asarray(scale),
               reduced=np.asarray(reduced), new_error=np.asarray(new_error))
    np.savez(d + "/jax.npz", **out)
""")


def _inputs():
    rng = np.random.default_rng(SEED)
    f32 = np.float32
    return {"x": rng.standard_normal((16, 64)).astype(f32),
            "w": rng.standard_normal((64, 32)).astype(f32),
            "g": rng.standard_normal((WORLD, 256)).astype(f32),
            "e": (0.01 * rng.standard_normal((WORLD, 256))).astype(f32)}


def _spawn(outdir: Path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.collective_worker,
                         args=(r, WORLD, str(outdir))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
            assert p.exitcode is not None, f"a rank hung past {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(WORLD):
        path = outdir / f"rank{r}.pkl"
        assert path.exists(), (r, procs[r].exitcode)
        res = pickle.loads(path.read_bytes())
        assert "error" not in res, res.get("error")
        out.append(res)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX's outputs, each port rank's outputs): the JAX
    subprocess runs while the ranks do."""
    d = tmp_path_factory.mktemp("collective")
    inputs = _inputs()
    np.savez(d / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    proc = subprocess.Popen([sys.executable, "-c", JAX_RUN, str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ranks = _spawn(d)
        _, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    with np.load(d / "jax.npz") as z:
        jax_out = dict(z)
    return inputs, jax_out, ranks


@pytest.mark.parametrize("n", [4, 2, 1])
def test_ring_matches_jax_and_the_product(runs, n):
    inputs, jax_out, ranks = runs
    want = inputs["x"] @ inputs["w"]
    np.testing.assert_allclose(jax_out[f"ring{n}"], want, rtol=RING_TOL,
                               atol=RING_TOL)
    for res in ranks:
        y = res[f"ring{n}"]
        assert y.shape == want.shape and y.dtype == np.float32
        np.testing.assert_allclose(y, jax_out[f"ring{n}"], rtol=RING_TOL,
                                   atol=RING_TOL)
        np.testing.assert_allclose(y, want, rtol=RING_TOL, atol=RING_TOL)


def test_crosspod_payload_scale_and_error_bit_equal_to_jax(runs):
    _, jax_out, ranks = runs
    for r, res in enumerate(ranks):
        assert res["q"].dtype == np.int8
        np.testing.assert_array_equal(res["q"], jax_out["q"][r:r + 1])
        assert res["scale"].view(np.uint32) == \
            jax_out["scale"][r:r + 1].view(np.uint32)
        np.testing.assert_array_equal(res["new_error"].view(np.uint32),
                                      jax_out["new_error"][r:r + 1]
                                      .view(np.uint32))


def test_crosspod_reduced_matches_jax(runs):
    inputs, jax_out, ranks = runs
    for r, res in enumerate(ranks):
        want = jax_out["reduced"][r:r + 1]
        err = np.abs(res["reduced"] - want).max()
        assert err <= REDUCED_REL * np.abs(want).max(), (r, err)
    # every pod holds the sum of the pods' dequantized parts, which is the
    # true sum up to int8 error (JAX's own check)
    true = (inputs["g"] + inputs["e"]).sum(0)
    scale = np.abs(inputs["g"] + inputs["e"]).max() / 127 * WORLD
    np.testing.assert_allclose(ranks[0]["reduced"][0], true, atol=WORLD * scale)


def test_ring_refuses_an_indivisible_d_in():
    x, w = torch.zeros((4, 62)), torch.zeros((62, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ring_allgather_matmul(x, w, SimpleNamespace(shape={"model": 4}))
    with pytest.raises(ValueError, match="rows"):
        ring_allgather_matmul_local(x[:, :31], w[:60])


def test_ring_is_forward_only():
    x = torch.zeros((4, 8), requires_grad=True)
    w = torch.zeros((8, 4))
    mesh = SimpleNamespace(shape={"model": 1})
    for call in (lambda: ring_allgather_matmul(x, w, mesh),
                 lambda: ring_allgather_matmul_local(x, w)):
        with pytest.raises(RuntimeError, match="forward only.*differentiates"):
            call()
    with torch.no_grad():
        assert ring_allgather_matmul(x, w, mesh).shape == (4, 4)


def test_ring_of_one_and_reduction_without_a_context_are_local():
    inp = _inputs()
    x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
    assert torch.equal(ring_allgather_matmul_local(x, w), x @ w)
    g, e = torch.from_numpy(inp["g"][:1]), torch.from_numpy(inp["e"][:1])
    q, scale, err = compress_with_feedback(g, e)
    reduced, new_error = crosspod_psum_compressed(g, e)
    assert torch.equal(reduced, dequantize_int8(q, scale))
    assert torch.equal(new_error, err)
