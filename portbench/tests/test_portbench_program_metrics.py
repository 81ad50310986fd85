"""The readers of the program's own counters and timer scopes, on a
synthetic registry, and the trace's reading of a profiled window whose host
events hold the program's spans."""

import time
from types import SimpleNamespace

import pytest

from dolfinx_materials_tpu_torch.utils import timers
from portbench import core, trace
from portbench.core import Cell


def reader(name):
    return Cell("plate.fused-plastic").reader(name)


@pytest.fixture(autouse=True)
def fresh_registry():
    timers.reset_timings()
    timers.set_tracing(False)
    yield
    timers.set_tracing(None)
    timers.reset_timings()


def record():
    rec = core.Record()
    rec.timed, rec.traced = core.Window(), core.Window()
    return rec


def profiled_only(fn):
    """``fn()`` under a profiler: what it records is left out by the
    readers of the registry."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        fn()


def test_budget_share_of_the_cg_iterations():
    timers.count("cg: iterations", 400)
    timers.count("cg: budget iterations", 100)
    profiled_only(lambda: timers.count("cg: budget iterations", 300))
    assert reader("cg_budget_its_pct.plate").read(record()) == pytest.approx(25.0)
    timers.reset_timings()
    timers.count("cg: iterations", 400)
    assert reader("cg_budget_its_pct.plate").read(record()) == 0.0


def test_host_reads_a_step():
    def steps(n, reads):
        for _ in range(n):
            with timers.timer("fused: step"):
                timers.count("host reads", reads)

    steps(4, 50)
    profiled_only(lambda: steps(1, 500))
    assert reader("host_reads_per_step.plate").read(record()) == pytest.approx(50.0)


def test_graph_launch_takes_the_untraced_replays_only():
    """Replays opened under a profiler are left out, even with the
    program's tracing off."""
    for _ in range(3):
        with timers.timer("cg: replay"):
            pass
    n, seconds = timers.timing("cg: replay")

    def slow_replay():
        with timers.timer("cg: replay"):
            time.sleep(0.05)

    profiled_only(slow_replay)
    timers.set_tracing(True)
    with timers.timer("cg: replay"):
        pass
    n, seconds = n + 1, timers.timing("cg: replay")[1] - timers.timing("cg: replay", profiled=True)[1]
    got = reader("graph_launch_us.plate").read(record())
    assert got == pytest.approx(1e6 * seconds / n) and got < 1e4


IDLE = ("idle_cg_pct.plate", "idle_line_search_pct.plate", "idle_newton_pct.plate", "idle_integrate_pct.points")


@pytest.mark.parametrize("name", ["cg_budget_its_pct.plate", "host_reads_per_step.plate", "graph_launch_us.plate",
                                  *IDLE, "store_device_pct.points"])
def test_nothing_to_read_gives_none(name, monkeypatch):
    assert reader(name).read(record()) is None
    # a program whose timers keep no counters and no traced scopes
    monkeypatch.delattr(timers, "counters")
    with timers.timer("fused: step"):
        pass
    with timers.timer("cg: replay"):
        pass
    assert reader(name).read(record()) is None


class Event:
    def __init__(self, name, a, b, device, annotation=False, tid=1):
        self._e = (name, a, b, device, annotation, tid)

    def name(self):
        return self._e[0]

    def start_ns(self):
        return self._e[1]

    def end_ns(self):
        return self._e[2]

    def device_type(self):
        return self._e[3]

    def is_user_annotation(self):
        return self._e[4]

    def start_thread_id(self):
        return self._e[5]


def profiled(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def test_program_spans_leave_the_trace_fields_as_they_were():
    """The program's spans (host events at function scope, no device
    ranges) change no field of the summary but the idle gaps' owners, and
    those keep their total."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    harness = [Event("portbench.window", 0, 900, cpu, True), Event("portbench.load_step", 5, 895, cpu, True),
               Event("portbench.load_step", 50, 880, cuda, True),
               Event("cudaGraphLaunch", 100, 120, cpu), Event("cudaStreamSynchronize", 300, 400, cpu),
               Event("kernel_a", 50, 100, cuda), Event("kernel_b", 130, 300, cuda), Event("kernel_a", 420, 600, cuda),
               Event("kernel_c", 700, 880, cuda)]
    program = [Event("fused: step", 10, 890, cpu), Event("cg: solve", 90, 410, cpu),
               Event("cg: replay", 95, 125, cpu), Event("fused: line search", 600, 700, cpu)]
    spans = ("window", "load_step")
    plain = trace.summarize(profiled(harness), 1.0, spans)
    traced = trace.summarize(profiled(harness + program), 1.0, spans)
    for field in ("window_s", "busy_s", "host_clipped", "device_clipped", "ops"):
        assert getattr(traced, field) == getattr(plain, field)
    assert plain.busy_s == pytest.approx((50 + 170 + 180 + 180) / 1e9)
    assert sum(traced.gaps.values()) == pytest.approx(sum(plain.gaps.values()))
    # the gap (600, 700) had no runtime call open: the program's span owns it
    assert plain.gaps["portbench.load_step"] == pytest.approx(100 / 1e9)
    assert traced.gaps["fused: line search"] == pytest.approx(100 / 1e9)
    assert traced.gaps["cudaGraphLaunch"] == plain.gaps["cudaGraphLaunch"]


def window_of(events, window_ns, spans):
    rec = record()
    rec.traced.trace = trace.summarize(profiled(events), window_ns / 1e9, spans)
    return rec


def traced(*names):
    """The program's scopes ``names``, opened with its tracing on (as they
    are under the profiler)."""
    timers.set_tracing(True)
    for n in names:
        with timers.timer(n):
            pass
    timers.set_tracing(False)


def plate_window():
    """A 1,000 ns profiled window of the plate: device busy 560 ns; its
    idle gaps owned by host Newton (50 ns), the CG's spans (60 + 100 ns), a
    graph launch inside a replay (30 ns), the line search (100 ns) and a
    synchronisation inside it (100 ns)."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [Event("portbench.window", 0, 1000, cpu, True), Event("portbench.load_step", 2, 998, cpu, True),
              Event("fused: step", 5, 995, cpu),
              Event("cg: solve", 150, 460, cpu), Event("cg: replay", 225, 235, cpu),
              Event("cg: replay", 305, 325, cpu), Event("cudaGraphLaunch", 310, 320, cpu),
              Event("fused: line search", 610, 880, cpu), Event("cudaStreamSynchronize", 840, 860, cpu)]
    for a, b in ((0, 50), (100, 200), (260, 300), (330, 400), (500, 600), (700, 800), (900, 1000)):
        events.append(Event("kernel", a, b, cuda))
    return window_of(events, 1000, ("window", "load_step"))


def test_idle_that_the_fused_steps_spans_own():
    rec = plate_window()
    assert all(reader(n).read(rec) is None for n in IDLE[:3])  # no span traced yet
    traced("fused: step", "fused: line search", "cg: solve", "cg: replay")
    cg, ls, newton = (reader(n).read(rec) for n in IDLE[:3])
    assert (cg, ls, newton) == (pytest.approx(16.0), pytest.approx(10.0), pytest.approx(5.0))
    idle = reader("device_idle_pct.plate").read(rec)
    assert idle == pytest.approx(44.0) and cg + ls + newton <= idle
    # the launch's and the synchronisation's idle stay theirs
    assert rec.traced.trace.gaps["cudaGraphLaunch"] == pytest.approx(30e-9)


def test_idle_that_the_material_update_owns():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [Event("portbench.window", 0, 1000, cpu, True), Event("portbench.update", 10, 600, cpu, True),
              Event("material: integrate", 20, 590, cpu), Event("J2: constitutive update", 30, 300, cpu),
              Event("material: store", 400, 580, cpu), Event("portbench.read", 600, 990, cpu, True),
              Event("kernel", 0, 50, cuda), Event("kernel", 150, 450, cuda), Event("cat", 500, 550, cuda),
              Event("kernel", 700, 1000, cuda)]
    rec = window_of(events, 1000, ("window", "update"))
    assert reader("idle_integrate_pct.points").read(rec) is None
    traced("material: integrate")
    # gaps (50, 150) in the update, (450, 500) in the store, (550, 700) in the read
    assert reader("idle_integrate_pct.points").read(rec) == pytest.approx(15.0)


def test_store_share_of_the_update_device_time():
    rec = record()
    rec.traced.trace = trace.Summary(1.0, 0.8, device_clipped={"update": 0.5},
                                     ops={"void at::native::(anonymous namespace)::CatArrayBatchedCopy_contig<double>": 0.1,
                                          "void j2_radial_return_kernel<double>": 0.35, "Memcpy DtoH": 0.05})
    assert reader("store_device_pct.points").read(rec) == pytest.approx(20.0)
