"""The yardstick's arithmetic: percentiles, rates, spreads, the byte count
of an elimination, and the reduction of a trace's intervals."""

import numpy as np
import pytest

from benchmark.harness import roofline, stats, trace
from benchmark.harness.trace import Interval

LAT = [0.080, 0.052, 0.061, 0.100, 0.047, 0.075, 0.066, 0.090, 0.058, 0.071, 0.083]


@pytest.mark.parametrize("q", [0, 5, 25, 50, 75, 95, 100])
def test_percentile_is_numpy_linear(q):
    assert stats.percentile(LAT, q) == pytest.approx(float(np.percentile(LAT, q)), abs=1e-15)


def test_percentile_by_hand():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([10.0], 95) == 10.0
    # 95th of 1..20: position 0.95 * 19 = 18.05 between 19 and 20
    assert stats.percentile(list(range(1, 21)), 95) == pytest.approx(19.05)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate():
    assert stats.rate(612, 51.0) == 12.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def _smoke():
    pytest.importorskip("torch")
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("rows,kw,live", [(20224, 8, 640), (20000, 8, 625), (67232, 8, 1),
                                          (40192, 4, 768), (1, 1, 1)])
def test_update_bytes_is_chip_smokes(rows, kw, live):
    assert roofline.update_bytes(rows, kw, live) == _smoke().update_bytes(rows, kw, live)


def test_elimination_bytes_at_the_flagship():
    rows, cols, kw = 20000, 19968, 8
    words = -(-(1 + cols) // 32)
    assert words == 625
    want = sum(4 * rows * kw + _smoke().update_bytes(rows, kw, words - 8 * t + (t > 0))
               for t in range(79))
    got = roofline.elimination_bytes(rows, cols)
    assert got == want
    # ~4.0 GB, ~1.19 ms at 3.35 TB/s
    assert 3.9e9 < got < 4.1e9


def test_live_words_rule():
    assert roofline.live_words(0, 625, 8) == 625
    assert roofline.live_words(1, 625, 8) == 618
    assert roofline.live_words(78, 625, 8) == 2
    # more rows, more bytes; the same per row
    a = roofline.elimination_bytes(20000, 19968)
    b = roofline.elimination_bytes(40000, 19968)
    assert a < b < 2 * a + 1


def test_peak_table():
    assert roofline.peak_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peak_for("cpu") is None


W = Interval("bench.window", 0.0, 100.0)


def test_busy_union_and_gaps():
    dev = [Interval("k", 10, 20), Interval("k", 15, 30), Interval("c", 50, 60),
           Interval("k", 95, 120), Interval("k", -5, 2)]
    assert trace.busy_intervals(dev, W) == [(0, 2), (10, 30), (50, 60), (95, 100)]
    assert trace.busy_us(dev, W) == 2 + 20 + 10 + 5
    assert trace.idle_gaps(dev, W) == [(2, 10), (30, 50), (60, 95)]
    assert trace.idle_gaps([], W) == [(0.0, 100.0)]


def test_idle_named_by_innermost_host_operation():
    dev = [Interval("k", 0, 10), Interval("k", 40, 60), Interval("k", 80, 100)]
    host = [Interval("bench.request", 0, 100), Interval("aten::copy_", 12, 38),
            Interval("cudaLaunchKernel", 20, 22), Interval("aten::where", 64, 68)]
    data = trace.TraceData(W, dev, host, trace.device_rows(dev))
    # gaps (10, 40) mid 25 -> aten::copy_; (60, 80) mid 70 -> bench.request (where ends at 68)
    out = trace.idle_by_host(data)
    assert out == {"aten::copy_": 30.0, "bench.request": 20.0}
    assert trace.top(out, 1) == [["aten::copy_", 30.0]]


def test_device_rows_sum_by_name():
    dev = [Interval("a", 0, 3), Interval("b", 3, 4), Interval("a", 5, 6)]
    assert trace.device_rows(dev) == [(4.0, "a", 2), (1.0, "b", 1)]


@pytest.mark.parametrize("name,library", [
    ("void (anonymous namespace)::scan_cluster_kernel<true, 3, false>(unsigned int const*, "
     "int const*, int*, int*, unsigned int*, int, int, int, int, int, int, int)", False),
    ("void (anonymous namespace)::table_update_kernel<0, false>(unsigned int*, unsigned int "
     "const*, unsigned int const*, int, int, int, int, int, int, int, int, unsigned long, "
     "unsigned long, unsigned long)", False),
    ("void (anonymous namespace)::coeff_blocked_kernel<8>(unsigned int const*, unsigned int "
     "const*, int const*, unsigned int*, int, int)", False),
    ("void (anonymous namespace)::scan_chunk_kernel<true, 5>(unsigned int const*)", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<int>, std::array<char*, 1ul>)", True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
     "namespace)::OpaqueType<4u>, unsigned int, 3, 64, 64>(...)", True),
    ("Memcpy HtoD (Pageable -> Device)", True),
    ("Memset (Device)", True),
])
def test_library_rows(name, library):
    assert trace.is_library(name) is library
