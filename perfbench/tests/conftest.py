"""Fixtures of the benchmark's CPU tests: the root on the path, the dilute
file and a small ionic-liquid file written by the program's writers."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the small ionic-liquid cell of the program's tests (352 atoms) and the
# cutoff and accuracy that fit its box
IL_SMALL = dict(n_pairs=40, sheets=1, nx=6, ny=4)
IL_SMALL_MD = dict(cutoff=7.0, kspace_accuracy=1e-5)


@pytest.fixture(scope="session", autouse=True)
def threads():
    torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.fixture(scope="session")
def dilute_file(tmp_path_factory):
    from lammps_user_conp2_tpu_torch import workloads
    return workloads.write_dilute_data(
        tmp_path_factory.mktemp("dilute") / "data", seed=5)


@pytest.fixture(scope="session")
def il_file(tmp_path_factory):
    from lammps_user_conp2_tpu_torch import workloads
    return workloads.write_il_data(tmp_path_factory.mktemp("il") / "data",
                                   seed=4)


@pytest.fixture(scope="session")
def il_small_file(tmp_path_factory):
    from lammps_user_conp2_tpu_torch import workloads
    return workloads.write_il_data(
        tmp_path_factory.mktemp("il_small") / "data", seed=3, **IL_SMALL)
