"""chip_smoke.py: its phases rehearsed at tiny sizes on the CPU, its refusal
of a CPU backend, and (marked `chip`) the phases at full size on a GPU."""

import jax
import numpy as np
import pytest

import chip_smoke

TINY_TAXI = (10, 9, 24)
TINY_VIDEO = (16, 12, 10)


def test_phase_taxi_matches_emulator_on_cpu():
    out = chip_smoke.phase_taxi(jax.devices("cpu")[0], shape=TINY_TAXI)
    assert out["row"]["shape"] == list(TINY_TAXI)
    # the "card" is the CPU here: its gap is the first CPU reference's own
    gaps = out["cpu_emulator_gaps"]
    assert len(gaps) == chip_smoke.TAXI_CPU_SAMPLES
    assert out["emulator_gap"] == gaps[0]
    assert max(gaps) < 1e-4


def test_phase_video_runs_metrics_and_cpu_reference(capsys):
    out = chip_smoke.phase_video(jax.devices("cpu")[0], shape=TINY_VIDEO)
    row = out["row"]
    assert row["shape"] == list(TINY_VIDEO)
    for k in ("psnr", "ssim", "f1", "map"):
        assert np.isfinite(row[k])
    # the same device on both sides: the comparison must be exact
    assert out["cpu_gap"] == 0.0
    assert "memory_analysis" in capsys.readouterr().out


def test_phase_cli_runs_console_entry_point():
    rows = chip_smoke.phase_cli(jax.devices("cpu")[0], max_iter=3)
    assert rows[0]["dataset"] == "sensor" and rows[0]["iters"] == 3


def test_phase_four_cards_matches_single_device(monkeypatch):
    # tiny 20-iteration problems; n1=16 splits over 4 slabs and 2x2
    from dataclasses import replace

    from tritd_tpu.utils import config

    monkeypatch.setattr(config, "VIDEO_TRITD",
                        replace(config.VIDEO_TRITD, max_iter=20))
    gaps = chip_smoke.phase_four_cards(jax.devices()[:4], shape=TINY_VIDEO)
    assert {"sharded", "auto", "batch_sharded[highway]"} <= set(gaps)
    assert len(gaps) == 6
    for g in gaps.values():
        assert g["max_rel_gap_first"] <= chip_smoke.VIDEO_CPU_RTOL
        assert g["max_abs_gap"] <= chip_smoke.SENSITIVITY_FACTOR * g["one_ulp_gap"]


def test_main_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.chip
def test_taxi_phase_on_gpu(gpu):
    chip_smoke.phase_taxi(gpu)


@pytest.mark.chip
def test_video_phase_on_gpu(gpu):
    chip_smoke.phase_video(gpu)
