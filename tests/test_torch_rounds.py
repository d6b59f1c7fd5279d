"""Three deterministic HAPFL rounds of the port against the reference
server on the CPU, at the small config of tests/test_batched.py (kept apart
from tests/test_torch_server.py so that each file's JAX compiles stay within
about a minute on one worker).

Across frameworks the float32 GEMMs and convolutions sum in another order,
so globals agree to atol 1e-4 / rtol 1e-3 rather than bitwise; the
host-side decisions (clients, sizes, intensities, simulated times) come from
the same numpy streams and must be identical."""
import jax
import pytest

pytest.importorskip("torch")

from repro import fl as jfl
from test_torch_server import KW, _assert_trees_close, _port_server


def test_three_rounds_match_reference_server():
    """3 deterministic Algorithm-1 rounds from the reference's globals and
    PPO params: identical host decisions and times, close globals."""
    jsrv = jfl.HAPFLServer(jfl.FLEnvironment(jfl.FLSimConfig(**KW)), seed=3,
                           engine="batched")
    srv = _port_server(jsrv, engine="batched")
    for _ in range(3):
        jr = jsrv.run_round(deterministic=True)
        tr = srv.run_round(deterministic=True)
        assert tr.clients == jr.clients
        assert tr.sizes == jr.sizes
        assert tr.intensities == jr.intensities
        assert tr.assess_times == jr.assess_times
        assert tr.local_times == jr.local_times
        assert tr.straggling == jr.straggling
        assert tr.reward_ppo1 == pytest.approx(jr.reward_ppo1, abs=1e-9)
        assert tr.reward_ppo2 == pytest.approx(jr.reward_ppo2, abs=1e-9)
        # params agree to ~1e-5, so an argmax may flip on one test sample
        for c in jr.clients:
            n = min(len(srv.env.partitions[c]), 256)
            for k in ("local", "lite"):
                assert abs(tr.client_acc[c][k]
                           - jr.client_acc[c][k]) <= 1.5 / n
        assert abs(tr.acc_lite - jr.acc_lite) <= 1.5 / KW["n_test"]
    _assert_trees_close(srv.lite_params, jax.device_get(jsrv.lite_params))
    for s in jsrv.global_by_size:
        _assert_trees_close(srv.global_by_size[s],
                            jax.device_get(jsrv.global_by_size[s]))
    assert set(srv.summary()) == set(jsrv.summary())
