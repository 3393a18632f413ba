"""Roofline accounting models and the per-device peak table
(utils/roofline.py)."""

import math

import pytest

from tritd_tpu.utils.roofline import (
    PEAKS,
    annotate,
    model_for,
    peaks_for,
    svt_admm_model,
    tritd_model,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_tritd_model_scales_with_tensor_size():
    small = tritd_model((10, 10, 10), 5)
    big = tritd_model((20, 10, 10), 5)
    assert big["flops_per_iter"] > small["flops_per_iter"]
    # bytes dominated by the 14 data-sized passes
    n = 20 * 10 * 10
    assert big["hbm_bytes_per_iter"] == 14 * n * 4
    assert big["working_set_bytes"] == 7 * n * 4


def test_svt_model_counts_every_cut():
    # chicago TT cuts: (77, 77*2016) and (77*77, 2016); the thin sides are
    # 77 and 2016, so the eigh term is dominated by 2016^3
    m = svt_admm_model((77, 77, 2016), "tt", "gram")
    assert m["flops_per_iter"] > 10 * 2016**3
    # warm:8 amortizes the eigh 8x -> strictly fewer flops than exact gram
    w = svt_admm_model((77, 77, 2016), "tt", "warm:8")
    assert w["flops_per_iter"] < m["flops_per_iter"]


def test_annotate_hbm_bound_and_vmem_residency():
    peak = PEAKS[H100]["hbm_gbps"]
    # chicago (47.8 MB/tensor) at 0.5 ms/iter: hbm-bound against the H100
    row = {}
    annotate(row, tritd_model((77, 77, 2016), 5), 5e-4, "walltime/n_iters",
             H100)
    r = row["roofline"]
    assert r["roofline_bound"] == "hbm"
    assert 0 < r["pct_hbm_peak"] <= 100
    assert r["achieved_gbps"] < peak
    assert r["device_kind"] == H100 and r["peak_hbm_gbps"] == peak
    assert r["peak_precision"] == "f32" and r["peak_tflops"] == 67.0
    # sensor (~1.2 MB/tensor) fast enough that the modeled traffic exceeds
    # the HBM peak: no cache-residency class exists any more — the row
    # reports the hbm roof and a share above 100%
    row2 = {}
    annotate(row2, tritd_model((54, 4, 1440), 5), 2e-6, "walltime/n_iters",
             H100)
    r2 = row2["roofline"]
    assert r2["roofline_bound"] == "hbm"
    assert r2["pct_hbm_peak"] > 100
    # at the bf16 peak the ridge moves, the bound does not
    row3 = {}
    annotate(row3, tritd_model((77, 77, 2016), 5), 5e-4, "walltime/n_iters",
             H100, precision="bf16")
    assert row3["roofline"]["peak_tflops"] == 989.0
    assert row3["roofline"]["pct_flop_peak"] < r["pct_flop_peak"]


def test_peak_table_raises_on_unknown_device():
    assert peaks_for(H100)["tflops"]["tf32"] == 495.0
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("Unlisted Accelerator")
    with pytest.raises(KeyError):
        annotate({}, tritd_model((10, 10, 10), 5), 1e-3, "walltime/n_iters",
                 "cpu")


def test_annotate_compute_bound_row():
    # a model far above the f32 ridge (~20 FLOP/B) is compute-bound
    model = {"flops_per_iter": 1e12, "hbm_bytes_per_iter": 1e9}
    row = {}
    annotate(row, model, 1.0, "walltime/n_iters", H100)
    assert row["roofline"]["roofline_bound"] == "compute"
    assert row["roofline"]["pct_flop_peak"] == pytest.approx(100 / 67, abs=0.01)


def test_model_for_dispatch():
    assert model_for("sofia", (23, 23, 2016), None) is None
    for method in ("triple", "ttnn", "ring"):
        m = model_for(method, (23, 23, 2016), "gram")
        assert m["flops_per_iter"] > 0 and m["hbm_bytes_per_iter"] > 0
    # fctn models the 4-way reshape
    m4 = model_for("fctn", (77, 77, 2016), "gram", fctn_subdim=8)
    assert m4["flops_per_iter"] > 0
    # bf16 storage halves the byte model
    f32 = model_for("triple", (77, 77, 2016), None, elem_bytes=4)
    bf16 = model_for("triple", (77, 77, 2016), None, elem_bytes=2)
    assert math.isclose(
        f32["hbm_bytes_per_iter"], 2 * bf16["hbm_bytes_per_iter"]
    )


def test_annotate_none_model():
    row = {}
    annotate(row, None, 1.0, "walltime/n_iters", H100)
    assert row["roofline"] is None
