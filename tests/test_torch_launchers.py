"""Every kernel wrapper of the port binds its launcher once a process.

`build.load` hashes a library's sources on every call (~0.15 ms on the
card's host), so each wrapper's launcher function is cached: it calls
`load` and declares the C signature once, and every later launch reuses
the bound function. Here, on the CPU, `load` is replaced by a counter that
hands out a stand-in library; tests/test_torch_cuda.py checks the same
across two real launches on the card.
"""

import types

import pytest

from yart_tpu_torch.kernels import blocktrace as legacy
from yart_tpu_torch.kernels import brute, clusterpairs, fusedtrace, presort, shade

LAUNCHERS = [  # (module, launcher function, library, its C launcher)
    (brute, "_library", "brute_intersect", "brute_intersect_launch"),
    (presort, "_library", "presort_keys", "presort_keys_launch"),
    (fusedtrace, "_library", "fused_trace", "fused_trace_launch"),
    (clusterpairs, "_library", "cluster_pairs", "cluster_pairs_launch"),
    (shade, "_draws_fn", "draws", "draws_launch"),
    (shade, "_shade_fn", "shade", "shade_launch"),
    (legacy, "_select_fn", "select_clusters", "select_clusters_launch"),
    (legacy, "_test_fn", "test_clusters", "test_clusters_launch"),
]


@pytest.mark.parametrize("mod, fn, lib, symbol", LAUNCHERS,
                         ids=[f"{m.__name__.split('.')[-1]}.{f}" for m, f, _, _ in LAUNCHERS])
def test_launcher_is_bound_once(monkeypatch, mod, fn, lib, symbol):
    calls = []
    stand_in = types.SimpleNamespace(**{symbol: types.SimpleNamespace()})
    monkeypatch.setattr(mod, "load", lambda name: (calls.append(name), (stand_in, False))[1])
    launcher = getattr(mod, fn)
    launcher.cache_clear()
    try:
        first, second = launcher(), launcher()
    finally:
        launcher.cache_clear()  # no stand-in outlives the test
    assert calls == [lib]
    assert first is second is getattr(stand_in, symbol)
    assert first.argtypes and first.restype is not None
