"""A whole run on the CPU (the program's plain twin standing in for the
kernel): sound, it comes out correct; with each fault planted under the
timed path, and with the control in the program's place, it does not."""
import pytest

from benchmark import control, faults, harness, spec


def limits(cell):
    return spec.config(spec.workload(spec.load_benchmark(), cell)["config"])[0]["limits"]


def test_sound_run_is_correct(small_mix):
    out = harness.run("cyl2_jet.frame", 2**31 + 12345, 0.05, False, device="cpu",
                      mix_override=small_mix)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    values = {k: v["value"] for k, v in out["checks"].items()}
    assert set(values) == {"windows_off_path", "photons_off", "scatter_count_off", "stat_z_max"}
    assert values["windows_off_path"] == values["photons_off"] == values["scatter_count_off"] == 0
    assert 0 < values["stat_z_max"] < limits("cyl2_jet.frame")["stat_z_max"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"photon_frames_per_s", "frame_ms_p90", "peak_mem_gib",
                                   "setup_s"}


@pytest.mark.parametrize("cell", ["cyl2_jet.frame", "amr_jet.frame"])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_makes_the_run_incorrect(cell, fault, fault_mix):
    with faults.planted(fault):
        out = harness.run(cell, 77, 0.05, False, device="cpu", mix_override=fault_mix)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["checks"]["stat_z_max"]["value"] > out["checks"]["stat_z_max"]["limit"]


def test_control_fails_and_faults_read_above_the_limits(fault_mix):
    lim = limits("cyl2_jet.frame")
    line = control.readings("cyl2_jet.frame", 5, True, device="cpu", mix_override=fault_mix)

    def fails(numbers):
        return any(numbers[k] > lim[k] for k in numbers if k in lim)

    assert not fails(line["program"])
    assert line["program"]["photons_off"] == 0
    ctl = line["control_bfloat16"]
    assert fails(ctl) and ctl["photons_off"] > 0.9 * line["photons"]
    for name in faults.FAULTS:
        assert fails(line[name]), name
    assert line["unchanged"]["photons_off"] == line["photons"]
    assert line["half"]["photons_off"] >= line["photons"] // 3
