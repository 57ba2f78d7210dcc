"""Device busy time from a profiler trace (utils/devtime.py), on small
XSpace traces built here in text form."""
import pytest

from jax.profiler import ProfileData

from cudacam_tpu.utils import devtime


def _event(meta, start_ns, dur_ns):
    return (f"events {{ metadata_id: {meta} offset_ps: {start_ns * 1000} "
            f"duration_ps: {dur_ns * 1000} }}")


def _plane(pid, name, lines):
    """lines: {line name: [(start_ns, dur_ns), ...]}"""
    body = []
    for lid, (lname, evs) in enumerate(lines.items(), 1):
        events = " ".join(_event(1, s, d) for s, d in evs)
        body.append(f'lines {{ id: {lid} name: "{lname}" timestamp_ns: 0 '
                    f"{events} }}")
    meta = 'event_metadata { key: 1 value { id: 1 name: "fusion" } }'
    return f'planes {{ id: {pid} name: "{name}" {" ".join(body)} {meta} }}'


def _trace(*planes):
    return ProfileData.from_text_proto("\n".join(planes)).planes


@pytest.mark.parametrize(
    "intervals,want",
    [
        ([], 0),
        ([(0, 5), (10, 12)], 7),            # disjoint
        ([(0, 5), (3, 9), (8, 10)], 10),    # chained overlaps
        ([(0, 10), (2, 3), (4, 6)], 10),    # nested
        ([(5, 6), (0, 2), (1, 3)], 4),      # unsorted
    ],
)
def test_union_merges_overlaps(intervals, want):
    assert devtime.union_ns(intervals) == want


def test_gpu_plane_counts_stream_lines_once():
    planes = _trace(
        _plane(1, "/device:GPU:0", {
            "Stream #13(compute)": [(0, 5000), (3000, 4000)],
            "Stream #14(memcpy)": [(6000, 2000), (20000, 1000)],
            "XLA Modules": [(0, 30000)],   # derived span: not kernel time
            "XLA Ops": [(0, 9000)],
        }),
        _plane(2, "/host:CPU", {"python": [(0, 50000)]}),
    )
    # union of [0,7000) [6000,8000) [20000,21000) = 9000
    assert devtime.device_busy_ns(planes, "gpu") == 9000


def test_planes_of_several_cards_add_up():
    planes = _trace(
        _plane(1, "/device:GPU:0", {"Stream #1": [(0, 1000)]}),
        _plane(2, "/device:GPU:1", {"Stream #1": [(0, 1000)]}),
    )
    assert devtime.device_busy_ns(planes, "gpu") == 2000


def test_gpu_trace_without_device_plane_raises():
    planes = _trace(_plane(1, "/host:CPU", {"python": [(0, 1000)]}))
    with pytest.raises(RuntimeError, match="/device:GPU:"):
        devtime.device_busy_ns(planes, "gpu")


def test_cpu_has_no_device_lane():
    planes = _trace(_plane(1, "/host:CPU", {"python": [(0, 1000)]}))
    assert devtime.device_busy_ns(planes, "cpu") is None
    assert devtime.device_time_ms_per_call(lambda: 0) is None
