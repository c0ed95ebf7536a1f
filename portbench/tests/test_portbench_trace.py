"""The trace's reduction on made-up events: busy as a union, idle gaps
labelled by the innermost host span, device events told apart with or
without the profiler's activity type."""

import numpy as np

from portbench import trace


class Ev:
    def __init__(self, name, dev, a, b, tid=1, activity=None):
        self._n, self._d, self._a, self._b, self._t = name, dev, a, b, tid
        if activity is not None:
            self.activity_type = lambda: activity

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def start_thread_id(self):
        return self._t


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda s: events})()})()


def _events(with_activity):
    a = (lambda k: k) if with_activity else (lambda k: None)
    return [
        Ev(trace.WINDOW, False, 0, 100, activity=a("user_annotation")),
        Ev("harness/submit", False, 0, 40, activity=a("user_annotation")),
        Ev("query/plan", False, 5, 30, activity=a("user_annotation")),
        Ev("harness/drain", False, 50, 100, tid=2, activity=a("user_annotation")),
        Ev("query/plan", True, 5, 30, activity=a("gpu_user_annotation")),  # a span's mirror
        Ev("fused_query_full_kernel", True, 30, 45, activity=a("kernel")),
        Ev("void at::elementwise_kernel<...>", True, 40, 60, activity=a("kernel")),
        Ev("Memcpy DtoH (Device -> Pinned)", True, 70, 75, activity=a("gpu_memcpy")),
        Ev("aten::copy_", False, 70, 71, activity=a("cpu_op")),
    ]


def test_reduce_with_and_without_activity_type():
    for with_activity in (True, False):
        names = trace.Names()
        names.names.add("query/plan")
        out = trace.reduce(Prof(_events(with_activity)), names)
        assert np.isclose(out["window_s"], 100e-9)
        assert np.isclose(out["busy_s"], 35e-9)  # [30, 60] and [70, 75]
        assert np.isclose(out["kernel_busy_s"], 30e-9)
        assert [n for n, _ in out["device_ops"]] == [
            "void at::elementwise_kernel<...>", "fused_query_full_kernel"
        ]
        gaps = dict(out["idle_gaps"])
        assert np.isclose(gaps["query/plan"], 30e-9)  # [0, 30]: plan inside submit
        assert np.isclose(gaps["harness/drain"], 35e-9)  # [60, 70] and [75, 100]


def test_union_and_segments():
    s, e = trace._union(np.array([5, 0, 20]), np.array([10, 6, 30]))
    assert s.tolist() == [0, 20] and e.tolist() == [10, 30]
    ss, se, sl = trace._segments([(0, 10, "a"), (2, 4, "b"), (6, 8, "c")])
    assert list(zip(ss.tolist(), se.tolist(), sl)) == [
        (0, 2, "a"), (2, 4, "b"), (4, 6, "a"), (6, 8, "c"), (8, 10, "a")
    ]
