"""The port's autoscaler (``serving/autoscaler.py``) against the JAX
package's: the same scripted recommendations under the same fake clock,
through both controllers with in-memory ``CallableLauncher`` fleets, give
the same ``status()`` after every tick, the same decision journal (the
flight recorder's ``autoscale_decision`` events, every field but the
timestamps) and the same ``tpu_autoscale_*`` render — hysteresis and
cooldown, the ``autoscale_launch_error`` (transient and fatal) and
``autoscale_drain_stuck`` faults, a clean drain, scale-to-zero with a
standby and a cold start. The scenarios are those of
``tests/test_autoscaler.py``.
"""

import json
import threading
import time

import pytest

from aws_k8s_ansible_provisioner_tpu.serving import autoscaler as jauto
from aws_k8s_ansible_provisioner_tpu.serving import chaos as jchaos
from aws_k8s_ansible_provisioner_tpu.serving import flightrec as jflight
from aws_k8s_ansible_provisioner_tpu_torch.serving import autoscaler as tauto
from aws_k8s_ansible_provisioner_tpu_torch.serving import capacity as tcap
from aws_k8s_ansible_provisioner_tpu_torch.serving import chaos as tchaos
from aws_k8s_ansible_provisioner_tpu_torch.serving import \
    flightrec as tflight

SIDES = {"jax": (jauto, jchaos, jflight), "port": (tauto, tchaos, tflight)}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for auto, chaos, flight in SIDES.values():
        monkeypatch.setattr(auto, "metrics", auto.AutoscaleMetrics())
        monkeypatch.setattr(flight, "metrics", flight.FlightMetrics())
        for mod in (auto, chaos, flight):
            mod.reset()
    yield
    for auto, chaos, flight in SIDES.values():
        for mod in (auto, chaos, flight):
            mod.reset()


class Run:
    """One controller over a scripted clock and an in-memory fleet (the
    launcher 'spawns' addresses, readiness is a set, inflight a dict),
    recording its status after every tick."""

    def __init__(self, side, **kw):
        self.auto, self.chaos, self.flight = SIDES[side]
        self.clk = FakeClock()
        self.seq = 0
        self.ready, self.inflight, self.stopped = set(), {}, []
        self.rec = {"recommended_replicas": 1, "offered_tps": 1.0,
                    "reporting_replicas": 1}
        cfg = dict(enabled=True, min_replicas=1, max_replicas=8,
                   stable_s=1.0, cooldown_s=10.0, standby=0,
                   clock=self.clk)
        cfg.update(kw)
        self.a = self.auto.Autoscaler(**cfg)
        self.a.install(
            launcher=self.auto.CallableLauncher(self._spawn, self._stop),
            ready_fn=lambda ad: ad in self.ready,
            inflight_fn=lambda ad: self.inflight.get(ad, 0),
            drain_fn=lambda ad: True, recommend_fn=lambda: self.rec)
        self.log = []

    def _spawn(self):
        self.seq += 1
        return f"10.0.0.{self.seq}:80", f"proc{self.seq}"

    def _stop(self, addr, opaque):
        self.stopped.append(addr)

    def at(self, t, ready=False):
        """Tick at ``t`` (every replica made ready first when asked)."""
        if ready:
            self.ready.update(h.addr for h in self.a._replicas.values())
        self.clk.t = t
        self.a.step()
        self.log.append(self.a.status())

    def result(self):
        self.a.export()
        journal = [{k: v for k, v in e.items() if not k.startswith("t_")}
                   for e in self.flight.get().tail(4096)
                   if e.get("type") == "autoscale_decision"]
        return {"status": self.log, "journal": journal,
                "stopped": self.stopped,
                "render": self.auto.metrics.registry.render(),
                "render_om": self.auto.metrics.registry.render(True)}


def _hysteresis(side):
    r = Run(side, stable_s=2.0, cooldown_s=10.0, max_replicas=4)
    r.at(0.0)
    r.at(0.5, ready=True)
    r.rec["recommended_replicas"] = 3
    for t in (1.0, 2.5, 3.0):
        r.at(t)
    r.at(3.5, ready=True)
    r.rec["recommended_replicas"] = 1          # reversal inside cooldown
    for t in (4.0, 6.5, 8.0):
        r.at(t)
    r.at(13.5)                                 # the cooldown is over
    for i, t in enumerate((14.0, 14.6, 15.2, 15.8, 16.4, 17.0)):
        r.rec["recommended_replicas"] = 3 if i % 2 else 1   # noise
        r.at(t, ready=True)
    return r.result()


def _launch_transient(side):
    r = Run(side, stable_s=0.0, launch_retries=3, backoff_base_s=2.0)
    r.chaos.get().inject("autoscale_launch_error", times=1)
    r.at(0.0)
    delay = r.a._pending[0]["next_t"]
    r.at(delay - 0.01)
    r.at(delay + 0.01)
    r.at(delay + 0.5, ready=True)
    return r.result()


def _launch_fatal(side):
    r = Run(side, stable_s=0.0)
    r.chaos.get().inject("autoscale_launch_error", times=1, mode="fatal")
    r.at(0.0)
    r.at(1.0)
    r.at(1.5, ready=True)
    return r.result()


def _retries_cap(side):
    r = Run(side, stable_s=0.0, launch_retries=2, backoff_base_s=0.5)
    r.chaos.get().inject("autoscale_launch_error", times=-1)
    for t in (0.0, 5.0, 10.0, 15.0, 20.0, 25.0):
        r.at(t)
    return r.result()


def _drain_stuck(side):
    r = Run(side, stable_s=1.0, cooldown_s=2.0, drain_stuck_s=5.0,
            drain_escalate_s=10.0, max_replicas=4)
    r.rec["recommended_replicas"] = 2
    r.at(0.0)
    r.at(1.0, ready=True)
    r.at(2.0)
    r.at(2.5, ready=True)
    r.chaos.get().inject("autoscale_drain_stuck", times=-1)
    r.rec["recommended_replicas"] = 1
    for t in (5.0, 6.5, 12.0, 17.0, 18.0):
        r.at(t)
    return r.result()


def _clean_drain(side):
    r = Run(side, stable_s=0.5, cooldown_s=1.0, max_replicas=4)
    r.rec["recommended_replicas"] = 2
    r.at(0.0)
    r.at(0.6, ready=True)
    r.at(1.2, ready=True)
    r.rec["recommended_replicas"] = 1
    r.at(3.0)
    r.at(3.6)
    victim = next(h.addr for h in r.a._replicas.values()
                  if h.state == r.auto.DRAINING)
    r.inflight[victim] = 1
    r.at(4.0)
    r.inflight[victim] = 0
    r.at(4.5)
    return r.result()


def _park_and_cold_start(side):
    r = Run(side, min_replicas=0, stable_s=1.0, cooldown_s=2.0,
            idle_timeout_s=10.0, standby=1)
    r.rec.update(recommended_replicas=1, offered_tps=0.0)
    r.a.adopt("10.9.9.1:80")
    r.ready.add("10.9.9.1:80")
    r.at(0.0)
    for t in (1.0, 11.0, 12.5, 13.0, 14.0):
        r.at(t, ready=True)
    got = []
    th = threading.Thread(
        target=lambda: got.append(r.a.request_cold_start(timeout_s=10.0)))
    th.start()
    t0 = time.monotonic()
    while not r.a.status()["cold_start_pending"]:
        assert time.monotonic() - t0 < 5.0, "the cold start never began"
        time.sleep(0.005)
    r.at(15.0)
    th.join(5.0)
    assert got == [True]
    r.at(16.0, ready=True)
    return r.result()


SCENARIOS = {"hysteresis": _hysteresis,
             "launch-transient": _launch_transient,
             "launch-fatal": _launch_fatal, "retries-cap": _retries_cap,
             "drain-stuck": _drain_stuck, "clean-drain": _clean_drain,
             "park-and-cold-start": _park_and_cold_start}

# decisions each scenario must journal (beside matching the JAX one)
WANT = {"hysteresis": {"scale_up", "flap_suppressed", "scale_down"},
        "launch-transient": {"launch_retry", "launch", "replica_ready"},
        "launch-fatal": {"launch_failed", "launch"},
        "retries-cap": {"launch_retry", "launch_failed"},
        "drain-stuck": {"drain", "drain_stuck", "drain_escalated"},
        "clean-drain": {"drain", "drained"},
        "park-and-cold-start": {"scale_down", "drained", "cold_start",
                                "promote_standby"}}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    got = {side: SCENARIOS[name](side) for side in SIDES}
    assert json.dumps(got["port"], sort_keys=True) == \
        json.dumps(got["jax"], sort_keys=True)
    decisions = {e["decision"] for e in got["port"]["journal"]}
    assert WANT[name] <= decisions, decisions
    assert "tpu_autoscale_desired_replicas" in got["port"]["render"]


def test_launch_failure_classes_reach_the_render():
    """The transient and fatal launch faults count under their class."""
    transient = _launch_transient("port")
    fatal = _launch_fatal("port")
    assert 'tpu_autoscale_launch_failures{class="transient"} 1' in \
        transient["render"]
    assert 'tpu_autoscale_launch_failures{class="fatal"} 1' in \
        fatal["render"]
    assert transient["status"][0]["pending_launches"] == 1
    assert fatal["status"][0]["pending_launches"] == 0


def test_ready_time_is_the_h100_replicas():
    """The default ready time (the launch deadline's and the standby's
    source) and the capacity headroom are one figure, the port replica's
    own on the card, not the JAX package's; an explicit value still wins
    and standby sizing follows it as in JAX."""
    assert tauto.DEFAULT_READY_S == tcap.DEFAULT_HEADROOM_S
    assert tauto.DEFAULT_READY_S != jauto.DEFAULT_READY_S
    assert tauto.DEFAULT_READY_S == int(tauto.DEFAULT_READY_S) > 0
    for auto in (jauto, tauto):
        assert auto.Autoscaler(standby=3).standby_target() == 3
        assert auto.Autoscaler(standby=-1, ready_s=0.0).standby_target() == 0
        assert auto.Autoscaler().standby_target() == 1


def test_command_launcher_formats_the_port_server():
    with pytest.raises(ValueError):
        tauto.CommandLauncher("python -m x")
    launcher = tauto.CommandLauncher(
        "python -m aws_k8s_ansible_provisioner_tpu_torch.serving.server "
        "--device cuda --host {host} --port {port}", host="127.0.0.1")
    assert launcher.template.format(host="h", port=1).endswith(
        "--host h --port 1")
