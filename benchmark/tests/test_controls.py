"""The check fails what it must: with the timed path broken underneath a
run (the look for a card skipped), ``correct`` comes out false once for
each fault a cell can have; on the card, the control (the reference one
precision lower in the program's place) fails each cell at its own size."""

import pytest
import torch

from benchmark import controls, run

CPU = torch.device("cpu")


def _correct(name):
    result, _ = run.run_cell(name, 4242, 0.3, False, CPU)
    return result["correct"], result["checks"]


def _wrap_pipeline(monkeypatch, change):
    from benchmark.traffic import camera

    setup = camera.Driver.setup

    def broken_setup(self):
        setup(self)
        inner = self.pipeline

        class Broken:
            def __getattr__(self, name):
                return getattr(inner, name)

            def __call__(self, frame, carry):
                return change(inner(frame, carry), carry)

        self.pipeline = Broken()

    monkeypatch.setattr(camera.Driver, "setup", broken_setup)


SMOOTHED = ["tiny-serve-gn4-stream", "tiny-serve-lm8-live"]


@pytest.mark.parametrize("cell", SMOOTHED)
def test_serving_sound_run_is_correct(tiny_bench, cell):
    assert _correct(cell)[0]


@pytest.mark.parametrize("cell", SMOOTHED)
def test_serving_state_left_unchanged_is_caught(tiny_bench, monkeypatch, cell):
    _wrap_pipeline(monkeypatch, lambda out, carry: (out[0], out[1], carry, out[3]))
    ok, checks = _correct(cell)
    assert not ok and checks["flags_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", SMOOTHED + ["tiny-serve-detect-only"])
def test_serving_answer_altered_where_produced_is_caught(tiny_bench, monkeypatch, cell):
    def alter(out, carry):
        kp = out[0].clone()
        kp[0, 0] += 1.0
        return (kp,) + tuple(out[1:])

    _wrap_pipeline(monkeypatch, alter)
    ok, checks = _correct(cell)
    assert not ok and checks["kp_gap_px"]["value"] > 0.5


@pytest.mark.parametrize("cell,reading", [("tiny-serve-gn4-stream", "pose_gap_px"),
                                          ("tiny-serve-lm8-live", "smoother_gap_median_px")])
def test_serving_pose_altered_where_produced_is_caught(tiny_bench, monkeypatch, cell, reading):
    from benchmark.traffic import camera

    _wrap_pipeline(monkeypatch, lambda out, carry: out[:3] + (camera._Pose(out[3].rot, out[3].trans + 0.01),))
    ok, checks = _correct(cell)
    assert not ok and checks[reading]["value"] > 10 * checks[reading]["limit"]


def test_the_lm8_smoother_cut_to_gn4_is_caught(tiny_bench):
    result, _ = run.run_cell("tiny-serve-lm8-live", 77, 0.3, False, CPU, control="gn4")
    checks = result["checks"]
    assert not result["correct"] and checks["smoother_gap_median_px"]["value"] > checks["smoother_gap_median_px"]["limit"]
    assert checks["kp_gap_px"]["value"] <= checks["kp_gap_px"]["limit"]  # the detector is as it was


def test_training_sound_run_is_correct(tiny_bench):
    assert _correct("tiny-train-resident-b256")[0]


def test_training_state_left_unchanged_is_caught(tiny_bench, monkeypatch):
    from perseus_tpu_torch.train import train as tm

    make = tm.make_device_data_train_step

    def frozen(*a, **k):
        step = make(*a, **k)
        return lambda state, *args, **kw: (state, step(state, *args, **kw)[1])

    monkeypatch.setattr(tm, "make_device_data_train_step", frozen)
    ok, checks = _correct("tiny-train-resident-b256")
    assert not ok and checks["update_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch_is_caught(tiny_bench, monkeypatch):
    from perseus_tpu_torch.train import train as tm

    loss = tm.smooth_l1_loss
    monkeypatch.setattr(tm, "smooth_l1_loss", lambda pred, target: loss(pred[: len(pred) // 2], target[: len(target) // 2]))
    ok, checks = _correct("tiny-train-resident-b256")
    assert not ok and checks["loss1_gap"]["value"] > 1e-3


@pytest.mark.parametrize("cell", SMOOTHED + ["tiny-serve-detect-only", "tiny-train-resident-b256"])
def test_the_control_fails_at_a_tiny_size(tiny_bench, cell):
    result, _ = run.run_cell(cell, 99, 0.3, False, CPU, control="fp8")
    assert not result["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,faults", [("serve-gn4-stream", ["fp8"]), ("serve-detect-only", ["fp8"]),
                                         ("train-resident-b256", ["fp8", "half_batch"]), ("serve-lm8-live", ["fp8", "gn4"])])
def test_the_control_fails_each_cell_at_its_size(cuda, cell, faults):
    for fault in faults:
        for seed in (101, 202, 303):
            result = controls.control_run(cell, seed, 2.0, cuda, fault)
            assert not result["correct"], (fault, seed, result["checks"])
