"""The port's reconfiguration simulator, live schedule driver and
hardware model against the JAX package's: the same schedules give the
same totals, telemetry and policy decision traces, exactly."""
import random

import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.core import hwmodel as jax_hw  # noqa: E402
from repro.core import scheduler as jax_sched  # noqa: E402
from repro.core.context import ContextDescriptor as JaxDesc  # noqa: E402
from repro.core.context import ContextSwitchEngine as JaxEngine  # noqa: E402
from repro.core.policy import ReconfigPolicy as JaxPolicy  # noqa: E402
from repro.core.telemetry import ManualClock as JaxClock  # noqa: E402
from repro.core.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro_torch.core import hwmodel  # noqa: E402
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core.context import (ContextDescriptor,  # noqa: E402
                                      ContextSwitchEngine)
from repro_torch.core.policy import ReconfigPolicy  # noqa: E402
from repro_torch.core.telemetry import ManualClock, Telemetry  # noqa: E402


def _random_case(rng: random.Random, max_nets=3):
    nets = [f"n{i}" for i in range(rng.randint(2, max_nets))]
    loads = {f"n{i}": rng.uniform(0.1, 30.0) for i in range(max_nets)}
    runs = [(rng.choice(nets), rng.uniform(0.1, 50.0), rng.randint(1, 4))
            for _ in range(rng.randint(1, 12))]
    return runs, loads


def test_simulators_equal_jax_on_random_schedules():
    rng = random.Random(7)
    for trial in range(150):
        runs, loads = _random_case(rng)
        port = [sched.Run(*r) for r in runs]
        jax_ = [jax_sched.Run(*r) for r in runs]
        slots = rng.randint(2, 4)
        assert (sched.simulate_conventional(port, loads)
                == jax_sched.simulate_conventional(jax_, loads))
        for upfront in (False, True):
            assert (sched.simulate_preloaded(port, loads, 1e-3, upfront)
                    == jax_sched.simulate_preloaded(jax_, loads, 1e-3,
                                                    upfront))
        tm = Telemetry(clock=ManualClock(), trace=True)
        jtm = JaxTelemetry(clock=JaxClock(), trace=True)
        pol, jpol = ReconfigPolicy(slots), JaxPolicy(slots)
        got = sched.simulate_dynamic(port, loads, num_slots=slots,
                                     switch_time=1e-3, policy=pol,
                                     telemetry=tm)
        want = jax_sched.simulate_dynamic(jax_, loads, num_slots=slots,
                                          switch_time=1e-3, policy=jpol,
                                          telemetry=jtm)
        assert got == want, trial
        assert pol.actions() == jpol.actions(), trial
        assert tm.registry.snapshot() == jtm.registry.snapshot(), trial
        assert tm.tracer.events() == jtm.tracer.events(), trial
        assert sched.time_saving(got + 1.0, got) == jax_sched.time_saving(
            want + 1.0, want)


def test_paper_case2_exact_numbers():
    """Fig 6(c/d): two preloaded nets, switch ~0: the saving is the
    reconfiguration share of the conventional total."""
    load = {"a": 10.0, "b": 10.0}
    s = [sched.Run("a", 1.0), sched.Run("b", 1.0)] * 5
    conv = sched.simulate_conventional(s, load)
    pre = sched.simulate_preloaded(s, load)
    assert conv == pytest.approx(110.0)
    assert pre == pytest.approx(10.0)
    assert sched.time_saving(conv, pre) == pytest.approx(100 / 110,
                                                         rel=1e-6)
    # Fig 6(e): load(next) < exec(current) hides every load but the first
    three = [sched.Run("a", 5.0), sched.Run("b", 5.0), sched.Run("c", 5.0)]
    load3 = {"a": 2.0, "b": 2.0, "c": 2.0}
    assert sched.simulate_dynamic(three, load3) == pytest.approx(17.0)
    assert sched.simulate_conventional(three, load3) == pytest.approx(21.0)


def test_hwmodel_equals_jax():
    names = [n for n in dir(jax_hw) if n.isupper()]
    assert names == [n for n in dir(hwmodel) if n.isupper()]
    for n in names:
        assert getattr(hwmodel, n) == getattr(jax_hw, n), n
    for tech in hwmodel.LUT_READ_DELAY_PS:
        for bench in hwmodel.VTR_BENCHMARKS:
            assert (hwmodel.critical_path_ps(tech, bench)
                    == jax_hw.critical_path_ps(tech, bench))
        assert (hwmodel.critical_path_delta(tech)
                == jax_hw.critical_path_delta(tech))
    for mb in (90.0, 180.0):
        assert hwmodel.reconfig_time_s(mb) == jax_hw.reconfig_time_s(mb)
    for nb in (1 << 20, 2_200_000_000):
        assert (hwmodel.context_load_time_s(nb)
                == jax_hw.context_load_time_s(nb))
        assert (hwmodel.context_load_time_s(nb, 50.0)
                == jax_hw.context_load_time_s(nb, 50.0))


def test_live_policy_trace_equals_simulator_and_jax():
    """The port's engine, driven by ``run_schedule_live`` (zero-cost loads,
    ``settle``), makes the simulator's decisions, and the JAX engine's
    under the same driver."""
    rng = random.Random(1234)
    nets = ["a", "b", "c"]
    for trial in range(15):
        slots = rng.choice([2, 2, 3])
        names = [rng.choice(nets) for _ in range(rng.randint(1, 10))]

        sim_pol = ReconfigPolicy(slots)
        sched.simulate_dynamic([sched.Run(n, 0.0, 1) for n in names],
                               {n: 0.0 for n in nets}, num_slots=slots,
                               policy=sim_pol)

        live_pol = ReconfigPolicy(slots)
        eng = ContextSwitchEngine(num_slots=slots, device="cpu",
                                  policy=live_pol)
        for n in nets:
            eng.register(ContextDescriptor(
                name=n, apply_fn=lambda p, x: x + p["w"],
                weights_fn=lambda: {"w": torch.ones(4)}))
        out = sched.run_schedule_live(
            eng, [sched.Run(n, 0.0, 1) for n in names],
            {n: (torch.zeros(4),) for n in nets}, dynamic=True,
            lookahead=None, settle=True)
        eng.shutdown()
        assert set(out) == {"total", "visible_stalls"}

        jpol = JaxPolicy(slots)
        jeng = JaxEngine(num_slots=slots, policy=jpol)
        for n in nets:
            jeng.register(JaxDesc(
                name=n, apply_fn=lambda p, x: x + p["w"],
                weights_fn=lambda: {"w": jnp.ones((4,), jnp.float32)}))
        jax_sched.run_schedule_live(
            jeng, [jax_sched.Run(n, 0.0, 1) for n in names],
            {n: (jnp.zeros((4,), jnp.float32),) for n in nets},
            dynamic=True, lookahead=None, settle=True)
        jeng.shutdown()
        assert sim_pol.actions() == live_pol.actions() == jpol.actions(), (
            trial, names, slots)


@pytest.mark.parametrize("dynamic", [True, False])
def test_live_schedule_serves_the_right_weights(dynamic):
    """Policy-driven eviction/prefetch (and the conventional reload path)
    never serves stale weights: each run reads its own context's."""
    scales = {"a": 1.0, "b": 2.0, "c": 3.0}
    seen = []
    eng = ContextSwitchEngine(num_slots=2, device="cpu")
    for n, s in scales.items():
        eng.register(ContextDescriptor(
            name=n,
            apply_fn=lambda p, n=n: seen.append((n, float(p["w"][0]))),
            weights_fn=lambda s=s: {"w": torch.full((4,), s)}))
    runs = [sched.Run(n, 0.0, 1) for n in "abcacba"]
    sched.run_schedule_live(eng, runs, {n: () for n in scales},
                            dynamic=dynamic)
    eng.shutdown()
    assert seen == [(n, scales[n]) for n in "abcacba"]
