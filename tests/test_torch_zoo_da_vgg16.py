"""vgg16 against the JAX package's, on the CPU: the case of
tests/test_torch_zoo_da_backbones.py (its docstring) that takes most of
that file's time, in a file of its own so that the two run side by side."""

import pytest
import torch

from test_torch_zoo_da_backbones import check_backbone


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_vgg16_matches_jax():
    check_backbone("vgg16")
