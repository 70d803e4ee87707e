"""The FLOP and byte counts against sums worked out by hand, at UMX-L and
UMX-HQ shapes."""

import pytest

from benchmarks.harness import cells, counts, generate


@pytest.fixture(scope="module")
def umxl():
    return cells.load_json("configs", "umxl")


@pytest.fixture(scope="module")
def umxhq():
    return cells.load_json("configs", "umxhq")


def test_model_flops_per_frame(umxl, umxhq):
    # per target: fc1 2974·H, fc2 2H·H, fc3 H·4098, three BLSTM layers of
    # two directions, each H·4G + G·4G; × 2 FLOPs × 4 targets
    assert counts.model_flops_per_frame(umxl) == 2 * 4 * (
        2974 * 1024 + 2048 * 1024 + 1024 * 4098 + 6 * (1024 * 2048 + 512 * 2048))
    assert counts.model_flops_per_frame(umxl) == 225_705_984
    assert counts.model_flops_per_frame(umxhq) == 70_909_952


def test_train_step_flops(umxhq):
    # 3 × forward × 16 rows × 256 frames: about 0.87 TFLOP a step
    assert counts.train_step_flops(umxhq) == 3 * 16 * 256 * 70_909_952
    assert counts.train_step_flops(umxhq) == pytest.approx(0.8713e12, rel=1e-3)


def test_recurrence_call(umxl):
    ops, nbytes = counts.recurrence_call(umxl, rows=1, steps=2584)
    assert ops == 2 * 8 * 2584 * 512 * 2048 == 43_352_326_144
    # xp f32 in, W_hh bf16 in, hs f32 out, h0 c0 hT cT f32
    assert nbytes == (8 * 2584 * 2048 * 4 + 8 * 512 * 2048 * 2 + 8 * 2584 * 512 * 4
                      + 4 * 8 * 512 * 4) == 228_524_032
    ops3, bytes3 = counts.recurrence_call(umxl, rows=3, steps=2584)
    assert ops3 == 3 * ops and bytes3 == 3 * (nbytes - 16_777_216) + 16_777_216


def test_recurrence_train_layer(umxhq):
    ops, nbytes = counts.recurrence_train_layer(umxhq, rows=16, steps=256)
    assert ops == 3 * 2 * 16 * 8 * 256 * 256 * 1024 == 51_539_607_552
    assert nbytes == 268_435_456 + 67_108_864 + 12_582_912


def test_wiener_segment(umxl):
    ops, nbytes = counts.wiener_segment(umxl, 2584)
    tf = 2584 * 2049
    # bf16 masks 4·2 planes, f32 mix re/im 2 channels, bf16 estimates re/im 4·2
    assert nbytes == tf * (4 * 2 * 2 + 2 * 2 * 4 + 4 * 2 * 2 * 2) == 338_855_424
    assert ops == tf * (16 + 40 + 32 + 14 + 128)


def test_least_time_takes_the_larger(umxl):
    ops, nbytes = counts.recurrence_call(umxl, rows=1, steps=2584)
    t = counts.least_time(ops, nbytes, "bf16_flops_per_s")
    assert t == pytest.approx(228_524_032 / 3.35e12)  # bytes bound it
    assert counts.least_time(1e15, 1.0, "bf16_flops_per_s") == pytest.approx(1e15 / 989e12)


def test_geometry_and_chunks(umxl):
    g = counts.geometry(umxl)
    assert g == {"seg": 2_646_000, "stride": 1_984_500, "max_shift": 22_050, "seg_frames": 2584}
    assert counts.track_chunks(230 * 44100, umxl) == 6  # (10 143 000 + 22 050) / 1 984 500
    assert counts.track_chunks(90 * 44100, umxl) == 3


def test_parameter_counts(umxl, umxhq):
    assert 112e6 < generate.param_count(umxl) < 114e6  # about 113 M
    assert 35e6 < generate.param_count(umxhq) < 37e6  # about 36 M
