"""``chip_smoke.py`` off the card: its refusal to run without a GPU, its
result line, and every phase's comparison at tiny sizes with the CPU as both
the timed device and the reference."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from triangulation_in_deformable_scenes_tpu.models import deformable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(
    chip_smoke.FULL_SIZES,
    sim_points=(24,),
    sim_locations=("FarPoints",),
    dense_n=30,
    pcg_n=(40,),
    matvec_n=40,
    lm_iters=3,
    serving=(4, 32, 4),
    frame=(96, 128),
    n_features=120,
    n_levels=3,
    match_sizes=(64,),
    four_n=64,
    four_pairs=4,
)


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture
def force_pcg(monkeypatch):
    """Send tiny problems to the block-PCG backend, as full-size ones go.
    The backend is chosen at trace time, so compiled solves are dropped on
    both sides of the patch."""
    jax.clear_caches()
    monkeypatch.setattr(deformable, "DENSE_DIM_LIMIT", 64)
    yield
    jax.clear_caches()


def test_refuses_to_run_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_exits_nonzero_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_result_line_has_exactly_the_contract_keys():
    line = json.loads(chip_smoke.result_line(jax.devices()))
    assert set(line) == {"ok", "device"}
    assert line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == len(jax.devices())
    assert line["device"]["platform"] == jax.devices()[0].platform


@pytest.mark.parametrize("full_reference_max", [10_000, 10])
def test_simulation_phase(cpu, tmp_path, monkeypatch, full_reference_max):
    """Both reference modes: the full run, and the first outer round."""
    monkeypatch.setattr(chip_smoke, "SIM_FULL_REFERENCE_MAX_POINTS", full_reference_max)
    chip_smoke.phase_simulation(cpu, cpu, TINY, 0, str(tmp_path))
    assert any(name.endswith(".txt") for name in os.listdir(tmp_path))


def test_dense_solve_phase(cpu):
    chip_smoke.phase_dense_solve(cpu, cpu, TINY, 0)


def test_pcg_solve_phase(cpu, force_pcg):
    chip_smoke.phase_pcg_solve(cpu, cpu, TINY, 0)


def test_serving_phase(cpu):
    chip_smoke.phase_serving(cpu, cpu, TINY, 0)


def test_frontend_phase(cpu):
    chip_smoke.phase_frontend(cpu, cpu, TINY, 0)


def test_four_cards_phase_on_virtual_devices(force_pcg):
    chip_smoke.phase_four_cards(jax.devices()[:4], TINY, 0)


def test_failed_check_fails_the_phase(cpu):
    ph = chip_smoke.Phase("probe", cpu)
    ph.check("value above bound", 2.0, 1.0, "test")
    with pytest.raises(chip_smoke.PhaseFailed):
        ph.finish()
