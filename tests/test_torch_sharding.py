"""The scenario mesh of one device (``repro_torch.distributed``):
``scenario_mesh`` counts the local devices of a type and returns
``None`` below ``min_devices``; ``shard_scenarios`` puts every array on
the one device of a mesh, dtype kept, and refuses a mesh of several
devices, whose split of the scenario axis is not ported."""
import numpy as np
import pytest
import torch

from repro_torch.distributed import scenario_mesh, shard_scenarios


def test_scenario_mesh_on_the_cpu():
    assert scenario_mesh(1, "cpu") == (torch.device("cpu"),)
    assert scenario_mesh(2, "cpu") is None
    assert scenario_mesh(min_devices=2, torch_device="cpu") is None


def test_scenario_mesh_needs_a_gpu_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario_mesh(1)


def test_shard_scenarios_places_on_the_one_device():
    arrays = {"temps": np.linspace(0.1, 1.0, 6).reshape(2, 3),
              "widx": np.array([0, 1], dtype=np.int32),
              "pair": torch.tensor([[True, False]]),
              "strided": np.arange(12.0).reshape(3, 4)[:, ::2]}
    out = shard_scenarios(arrays, (torch.device("cpu"),))
    assert list(out) == list(arrays)
    for k, x in arrays.items():
        t = out[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(x))
        assert t.numpy().dtype == np.asarray(x).dtype
    assert out["pair"] is arrays["pair"]        # already there: no copy


def test_shard_scenarios_refuses_several_devices():
    mesh = (torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 11"):
        shard_scenarios({"ci": np.zeros(4)}, mesh)


@pytest.mark.cuda
def test_cuda_mesh_of_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = scenario_mesh(1)
    assert len(mesh) == torch.cuda.device_count()
    if len(mesh) == 1:
        out = shard_scenarios({"ci": np.arange(3.0)}, mesh)
        assert out["ci"].device.type == "cuda"
        assert out["ci"].dtype == torch.float64
