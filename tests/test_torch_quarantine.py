"""The port's dispatch quarantine and ``run_guarded`` on the CPU: the TTL,
probation, recovery and backoff state machine under a fake clock (held
equal to the JAX package's), the per-site memo invalidated by a quarantine,
the three guarded call sites (linear, conv, paged attention) degrading with
the same output, the exceptions that are not degraded around, and, on a
faked CUDA device, a ladder that never reaches a plain-PyTorch
candidate."""
import numpy as np
import pytest
import torch

from _paged_cases import problem
from repro import dispatch as jdispatch
from repro.dispatch import dispatch as jdmod
from repro_torch import dispatch, fault, obs
from repro_torch.core.pruning import SparsityConfig
from repro_torch.core.sparse_conv import conv_init
from repro_torch.core.sparse_linear import forward_compressed_xla, linear_apply, linear_init
from repro_torch.dispatch import dispatch as dmod
from repro_torch.kernels import _build
from repro_torch.kernels.conv_gemm.ops import conv2d_sparse, conv2d_xla_ref
from repro_torch.kernels.flash_attn import paged_attention, paged_attention_ref

SPARSE = ("values", "idx")
TOL = 1e-5  # of max|y|, where a retry runs another plain version


@pytest.fixture(autouse=True)
def clean(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    dispatch.clear_quarantine()
    jdispatch.clear_quarantine()
    dispatch.set_quarantine_ttl_s(30.0)
    yield
    dispatch.clear_quarantine()
    jdispatch.clear_quarantine()
    dispatch.set_quarantine_ttl_s(30.0)
    dispatch.set_db(None)
    fault.uninstall()
    obs.set_enabled(False)
    obs.reset()


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both packages, base TTL 10 s."""
    t = [100.0]
    monkeypatch.setattr(dmod, "_now", lambda: t[0])
    monkeypatch.setattr(jdmod, "_now", lambda: t[0])
    monkeypatch.setenv("REPRO_DISPATCH_QUARANTINE_TTL_S", "10")
    dispatch.set_quarantine_ttl_s(10.0)
    return t


@pytest.fixture
def on_card(monkeypatch):
    """Lookups see a CUDA device; the tensors stay on the CPU, where every
    kernel wrapper runs its plain version."""
    monkeypatch.setattr(dmod, "resolve_device",
                        lambda device=None: torch.device("cuda"))


def _linear(d_in=64, d_out=128, rows=8, tile=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    sp = SparsityConfig(sparsity=0.5, m=None, tile=tile, min_dim=16,
                        format="compressed_pallas")
    layer = linear_init(gen, d_in, d_out, sp, device="cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, d_in), dtype=np.float32))
    return layer, x


def _close(y, want):
    assert y.shape == want.shape
    assert float((y - want).abs().max()) <= TOL * float(want.abs().max())


# ---------------------------------------------------------------------------
# The state machine, against JAX's
# ---------------------------------------------------------------------------


def test_quarantine_query_and_clear():
    assert dispatch.quarantined() == frozenset()
    assert dispatch.quarantine("linear", "compressed_xla", reason="boom")
    assert not dispatch.quarantine("linear", "compressed_xla")
    assert dispatch.quarantined() == {("linear", "compressed_xla")}
    assert dispatch.quarantined("linear") == {"compressed_xla"}
    assert dispatch.quarantine_info("linear", "compressed_xla")["reason"] == "boom"
    dispatch.clear_quarantine()
    assert dispatch.quarantined() == frozenset()
    assert dispatch.quarantine_info("linear", "compressed_xla") is None


def test_a_geometry_variant_quarantines_its_family():
    """Every geometry of a family launches the same hand-written kernel."""
    assert dispatch.family("fused_sparse_pallas@v256_bk128") == \
        "fused_sparse_pallas"
    dispatch.quarantine("conv", "fused_sparse_pallas@v128_bk64")
    assert dispatch.quarantined("conv") == {"fused_sparse_pallas"}
    assert dmod._is_quarantined("conv", "fused_sparse_pallas")
    assert dmod._is_quarantined("conv", "fused_sparse_pallas@v256_bk128")
    assert not dmod._is_quarantined("conv", "fused_banded_pallas")


@pytest.mark.parametrize("fails", [1, 3, 9])
def test_ttl_probation_and_backoff_equal_jax(clock, fails):
    """The same events under the same clock leave the same entry in both
    packages: the TTL doubles per failed re-probe, capped at 2**6 times the
    base, and an expired entry is on probation."""
    states = []
    for _ in range(fails):
        for q in (dispatch, jdispatch):
            assert q.quarantine("linear", "compressed_pallas", reason="x")
        ours = dispatch.quarantine_info("linear", "compressed_pallas")
        assert ours == jdispatch.quarantine_info("linear", "compressed_pallas")
        states.append(ours)
        clock[0] += ours["until"] - clock[0] - 0.5
        dmod._sweep_expired()
        jdmod._sweep_expired()
        assert not dispatch.quarantine_info("linear", "compressed_pallas")[
            "probation"]
        clock[0] += 0.5
        dmod._sweep_expired()
        jdmod._sweep_expired()
        assert dispatch.quarantine_info("linear", "compressed_pallas") == \
            jdispatch.quarantine_info("linear", "compressed_pallas")
        assert dispatch.quarantined("linear") == frozenset()
    ttl = [s["until"] - t for s, t in zip(
        states, [100.0] + [s["until"] for s in states[:-1]])]
    assert ttl == [10.0 * 2 ** min(i, 6) for i in range(fails)]


def test_nonpositive_ttl_never_expires(clock):
    dispatch.set_quarantine_ttl_s(0)
    assert dispatch.quarantine_ttl_s() == 0
    dispatch.quarantine("linear", "compressed_xla")
    clock[0] += 1e9
    dmod._sweep_expired()
    assert dispatch.quarantined("linear") == {"compressed_xla"}


# ---------------------------------------------------------------------------
# Guarded execution on the CPU
# ---------------------------------------------------------------------------


def test_a_quarantine_invalidates_the_site_memo():
    """A quarantined family stops running at once: the per-site memo's key
    carries the quarantine generation, so the warm memo is not reused."""
    layer, x = _linear()
    want = linear_apply(layer, x)  # warms the memo with compressed_xla
    dispatch.quarantine("linear", "compressed_xla")
    with fault.fault_scope("dispatch.execute@compressed_xla:n=5") as plan:
        y = linear_apply(layer, x)
    assert plan.fired == {} and plan.probes == {"dispatch.execute": 1}
    _close(y, want)
    dispatch.clear_quarantine()  # and the plain version runs again
    with fault.fault_scope("dispatch.execute@compressed_xla:n=1") as plan:
        _close(linear_apply(layer, x), want)
    assert plan.fired == {"dispatch.execute": 1}


def test_linear_degrades_with_the_same_output_and_records_it():
    layer, x = _linear()
    want = forward_compressed_xla(x, layer["values"], layer["idx"])
    obs.set_enabled(True)
    with fault.fault_scope("dispatch.execute@compressed_xla:n=1") as plan:
        y = linear_apply(layer, x)
    assert plan.fired == {"dispatch.execute": 1}
    _close(y, want)
    assert dispatch.quarantined("linear") == {"compressed_xla"}
    names = [e["name"] for e in obs.events()]
    assert names.count("dispatch.quarantine") == 1
    assert names.count("dispatch.execute_retry") == 1
    counters = obs.snapshot()["counters"]
    assert counters["dispatch.quarantine"] == 1
    assert counters["dispatch.execute_retries"] == 1


def test_probation_recovers_and_a_failed_reprobe_backs_off(clock):
    layer, x = _linear()
    with fault.fault_scope("dispatch.execute@compressed_xla:n=1"):
        linear_apply(layer, x)
    assert dispatch.quarantine_info("linear", "compressed_xla")["fails"] == 1
    clock[0] += 10.0  # expired: the next lookup re-probes compressed_xla
    with fault.fault_scope("dispatch.execute@compressed_xla:n=1"):
        linear_apply(layer, x)
    info = dispatch.quarantine_info("linear", "compressed_xla")
    assert info["fails"] == 2 and not info["probation"]
    assert info["until"] == clock[0] + 20.0
    clock[0] += 20.0
    with fault.fault_scope("dispatch.execute:n=0") as plan:
        linear_apply(layer, x)  # a clean re-probe
    assert plan.probes == {"dispatch.execute": 1}
    assert dispatch.quarantine_info("linear", "compressed_xla") is None


@pytest.mark.parametrize("exc", [RuntimeError("nvcc failed on x.cu"),
                                 RuntimeError("CUDA error: an illegal memory "
                                              "access was encountered"),
                                 _build.DeviceError("must be a CUDA tensor")])
def test_build_launch_and_device_errors_are_not_degraded_around(exc):
    layer, x = _linear()
    key = dispatch.linear_key_from(x.shape, layer["values"].shape, x.dtype)
    spec = dispatch.best_impl(key, param_keys=SPARSE, device="cpu")
    calls = []

    def call(s):
        calls.append(s.name)
        raise exc

    with pytest.raises(type(exc), match=str(exc)[:10]):
        dispatch.run_guarded(key, spec, call, param_keys=SPARSE, device="cpu")
    assert calls == [spec.name] and dispatch.quarantined() == frozenset()


@pytest.mark.parametrize("exc", [ValueError("block_k=4096 needs too much"),
                                 TypeError("values must have dtype"),
                                 dispatch.TuningError("no geometry fits")])
def test_a_wrapper_refusal_is_degraded_around(exc):
    layer, x = _linear()
    key = dispatch.linear_key_from(x.shape, layer["values"].shape, x.dtype)
    spec = dispatch.best_impl(key, param_keys=SPARSE, device="cpu")
    calls = []

    def call(s):
        calls.append(s.name)
        if len(calls) == 1:
            raise exc
        return s.apply(layer, x)

    y = dispatch.run_guarded(lambda: key, spec, call, param_keys=SPARSE,
                             device="cpu")
    assert calls[0] == spec.name and len(calls) == 2 and calls[1] != spec.name
    assert dispatch.quarantined("linear") == {spec.name}
    _close(y, forward_compressed_xla(x, layer["values"], layer["idx"]))


def test_conv_degrades_inside_the_autograd_twin():
    """The guard sits in the forward ``_ConvSparse`` runs, so a training
    step degrades too, with the same output and gradient."""
    gen = torch.Generator().manual_seed(1)
    sp = SparsityConfig(sparsity=0.5, m=None, tile=None, min_dim=16,
                        format="compressed_pallas")
    layer = conv_init(gen, 16, 32, 3, 3, sp, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 2, 8, 8), dtype=np.float32))
    args = dict(kh=3, kw=3, stride=1, pad=1, v=32)
    want = conv2d_xla_ref(x, layer["values"], layer["idx"], **args)
    values = layer["values"].clone().requires_grad_(True)
    with fault.fault_scope("dispatch.execute@im2col_sparse_xla:n=1") as plan:
        y = conv2d_sparse(x, values, layer["idx"], **args)
        y.sum().backward()
    assert plan.fired == {"dispatch.execute": 1}
    assert dispatch.quarantined("conv") == {"im2col_sparse_xla"}
    _close(y.detach(), want)
    ref_values = layer["values"].clone().requires_grad_(True)
    conv2d_sparse(x, ref_values, layer["idx"], impl="im2col_sparse_xla",
                  **args).sum().backward()
    _close(values.grad, ref_values.grad)


def test_paged_attention_kernel_site_degrades_with_the_same_output():
    arrays = [torch.from_numpy(a) for a in problem(b=2, lengths=[13, 7])]
    want = paged_attention_ref(*arrays)
    with fault.fault_scope("kernel.paged_attn:n=1") as plan:
        got = paged_attention(*arrays, page_size=8)
    assert plan.fired == {"kernel.paged_attn": 1}
    assert plan.probes == {"dispatch.execute": 2, "kernel.paged_attn": 2}
    assert dispatch.quarantined("paged_attn") == {"paged_attn_ref"}
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On a (faked) CUDA device: the hand-written kernels alone
# ---------------------------------------------------------------------------


def _retried(events):
    return [(e["args"]["failed"], e["args"]["retry"]) for e in events
            if e["name"] == "dispatch.execute_retry"]


@pytest.mark.parametrize("impl", [None, "compressed_xla", "compressed_tiled"])
def test_the_card_never_retries_a_torch_candidate(on_card, impl):
    """Every candidate fails: the ladder runs through the cuda families
    (after a forced plain version too) and raises once none is left."""
    layer, x = _linear()
    obs.set_enabled(True)
    with fault.fault_scope("dispatch.execute:p=1"):
        with pytest.raises(fault.InjectedFault):
            linear_apply(layer, x, impl=impl)
    retried = _retried(obs.events())
    assert retried, "nothing was retried"
    for _failed, retry in retried:
        assert dispatch.REGISTRY.get("linear", retry).backend == "cuda", retry
    assert dispatch.quarantined("linear") >= {"compressed_tiled",
                                              "compressed_pallas"}
    assert {dispatch.REGISTRY.get("linear", r).backend
            for _, r in retried} == {"cuda"}


def test_the_card_retries_the_next_kernel_family(on_card):
    layer, x = _linear()
    want = forward_compressed_xla(x, layer["values"], layer["idx"])
    obs.set_enabled(True)
    with fault.fault_scope("dispatch.execute@compressed_tiled:n=1"):
        y = linear_apply(layer, x)
    assert _retried(obs.events()) == [("compressed_tiled", "compressed_pallas")]
    _close(y, want)
    # the memo holds the degraded choice until the quarantine clears
    with fault.fault_scope("dispatch.execute@compressed_tiled:n=1") as plan:
        linear_apply(layer, x)
    assert plan.fired == {}
    dispatch.clear_quarantine()
    with fault.fault_scope("dispatch.execute@compressed_tiled:n=1") as plan:
        linear_apply(layer, x)
    assert plan.fired == {"dispatch.execute": 1}
