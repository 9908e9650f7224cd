"""PyTorch port: a prefix of the reference's 90,000-step fleet parity test.

`tests/test_plant.py::test_all_backends_match_oracle_pole_90k` holds every
reference backend to its frozen oracle over 90,000 steps of a uniform ρ
trace (4 packages × 2 tiles, v24, the trace of seed 3).  Here the first
steps of that same trace go through every port backend on the CPU, against
the reference's broadcast engine (bit-equal to that oracle): event counts
exact, the thermal state and the frequency within 1e-5.  The whole 90k run
takes minutes a backend on the CPU, so each backend runs a prefix sized to
its cost a step (`PREFIX`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core.scheduler import SchedulerConfig as JCfg
from repro.fleet import FleetEngine as JEngine

from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fleet import FleetEngine, available_backends

N, N_TILES, SEED, STEPS_90K = 4, 2, 3, 90_000
TOL = dict(rtol=1e-5, atol=1e-5)
# steps a backend runs: the fused kernel's plain version, the cheapest a
# step, takes the whole prefix
PREFIX = {"fused": 3000, "broadcast": 2000, "sharded_fused": 1000,
          "vmap": 750, "sharded": 750}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: at 4 × 2 lanes a step is a few hundred tiny
    ops, which more threads only slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """(trace [3,000, n, tiles] numpy, {steps: reference state there}):
    the first 3,000 steps of the 90k test's trace, drawn whole as it
    draws it, and the reference's broadcast engine's state after each
    prefix length."""
    key = jax.random.PRNGKey(SEED)
    full = 0.9 + 1.8 * jax.random.uniform(key, (STEPS_90K, N, N_TILES))
    trace = np.asarray(full[:max(PREFIX.values())])
    eng = JEngine(JCfg(n_tiles=N_TILES, mode="v24"), backend="broadcast",
                  donate_state=False)
    st, done, states = eng.init(N), 0, {}
    for k in sorted(set(PREFIX.values())):
        st, _ = eng.run_chunked(st, jnp.asarray(trace[done:k]),
                                flush_every=9_000)
        states[k], done = jax.device_get(st), k
    # the prefix exercises the law: it throttles and trips events
    assert np.asarray(states[max(PREFIX.values())].events).sum() > 0
    return trace, states


def test_every_backend_has_a_prefix():
    assert set(PREFIX) == set(available_backends())


@pytest.mark.parametrize("backend", sorted(PREFIX))
def test_backend_matches_the_reference_over_a_prefix(reference, backend):
    trace, states = reference
    steps = PREFIX[backend]
    eng = FleetEngine(SchedulerConfig(n_tiles=N_TILES, mode="v24"),
                      backend=backend, device="cpu")
    st, _ = eng.run_chunked(eng.init(N), torch.tensor(trace[:steps]),
                            flush_every=9_000)
    st, want = eng.gather(st), states[steps]
    np.testing.assert_array_equal(st.events.numpy(),
                                  np.asarray(want.events))
    np.testing.assert_allclose(st.thermal.numpy(), np.asarray(want.thermal),
                               **TOL)
    np.testing.assert_allclose(st.freq.numpy(), np.asarray(want.freq), **TOL)
