"""``--experimental`` inference and ``python -m
skoots_tpu_torch.experimental`` against the JAX package on the CPU."""

import glob

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy import ndimage

from skoots_tpu.cli import main as jax_cli
from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.models import init_model
from skoots_tpu.train.checkpoint import save_checkpoint
from skoots_tpu.train.generate_skeletons import save_skeletons
from skoots_tpu.utils.io import imread, imsave
from skoots_tpu.utils.synthetic import make_tubes
from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.cli import main as torch_cli
from skoots_tpu_torch.experimental import eval as XEV
from skoots_tpu_torch.experimental.__main__ import main as experimental_main

TINY_MODEL = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
              "KERNEL_SIZE": 3, "DTYPE": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def volume_and_ckpt(tmp_path_factory):
    """A 48x48x8 tube volume and a tiny f32 checkpoint of seeded weights."""
    d = tmp_path_factory.mktemp("experimental")
    cfg = get_cfg_defaults()
    cfg.merge_from_dict({"MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}})
    _, params = init_model(cfg, jax.random.PRNGKey(3), spatial=(16, 16, 8))
    ckpt = str(d / "tiny.skoots")
    save_checkpoint(ckpt, cfg, params, dataset_mean=100.0, dataset_std=50.0)
    img, labels, skels = make_tubes(shape=(48, 48, 8), n_tubes=2, radius=3, seed=5)
    return d, img, labels, skels, ckpt


def test_experimental_cli_mask_equals_skoots(volume_and_ckpt, tmp_path):
    """``skoots-torch --experimental --device cpu`` writes the mask that
    ``skoots --experimental`` writes."""
    _, img, _, _, ckpt = volume_and_ckpt
    masks = {}
    for side, cli, extra in (("jax", jax_cli, ["--spatial-shards", "0"]),
                             ("torch", torch_cli, ["--device", "cpu"])):
        vol = tmp_path / f"{side}.tif"
        imsave(str(vol), img)
        assert cli(["--image", str(vol), "--pretrained-checkpoint", ckpt, "--experimental",
                    "--log", "0"] + extra) == 0
        masks[side] = imread(str(tmp_path / f"{side}_instance_mask.tif"))
    assert masks["jax"].max() >= 1  # the tiny model's mask holds instances
    np.testing.assert_array_equal(masks["torch"], masks["jax"])


def test_eval_applies_the_tuned_knobs(monkeypatch):
    """A knob passed as None takes its tuned value; any other value wins."""
    seen = {}
    monkeypatch.setattr(XEV, "run_inference", lambda *a, **k: seen.update(k))
    XEV.eval("v.tif", "m.skoots", dilation_3d=None, dilation_2d=None, prob_threshold=0.7,
             device="cpu")
    assert seen == {"prob_threshold": 0.7, "dilation_3d": 0, "dilation_2d": 3,
                    "embed_iterations": 10, "embed_decay": 0.95, "device": "cpu"}


def test_experimental_module_runs_both_modes(volume_and_ckpt, tmp_path, monkeypatch):
    """``python -m skoots_tpu_torch.experimental``: ``--config-file``
    trains sparse with ``IS_SPARSE`` forced on; ``--image`` with
    ``--pretrained-checkpoint`` segments with the tuned knobs (the mask of
    ``skoots-torch --experimental``; a ``.npy`` volume's mask is written as
    ``.npy``); with neither it prints usage and returns 2."""
    d, img, labels, skels, ckpt = volume_and_ckpt
    monkeypatch.chdir(tmp_path)
    assert experimental_main([]) == 2

    data = tmp_path / "data"
    data.mkdir()
    imsave(str(data / "v.tif"), img)
    imsave(str(data / "v.background.tif"),
           (ndimage.distance_transform_edt(labels == 0) > 6).astype(np.uint8))
    save_skeletons(str(data / "v.skeletons.npz"), skels)
    cfg = {"MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
           "TRAIN": {"TRAIN_DATA_DIR": [str(data)], "TRAIN_SAMPLE_PER_IMAGE": [1],
                     "NUM_EPOCHS": 1, "SAVE_INTERVAL": 1, "SAVE_PATH": str(tmp_path / "m"),
                     "MAX_SKELETON_POINTS": 64, "LOSS_SKELETON_START_EPOCH": -1},
           "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8},
           "EXPERIMENTAL": {"DIST_THR": 3.0}}  # IS_SPARSE left off
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    assert experimental_main(["--config-file", str(tmp_path / "cfg.yaml"),
                              "--steps-per-epoch", "1", "--log", "0", "--device", "cpu"]) == 0
    (saved,) = glob.glob(str(tmp_path / "m" / "*_sparse.skoots"))
    ck = load_checkpoint(saved)
    assert ck["cfg"]["EXPERIMENTAL"]["IS_SPARSE"] is True and ck["extra"]["epoch"] == 0

    # a .npy volume, as on a machine without Pillow: the mask is a .npy too
    np.save(tmp_path / "module.npy", img)
    imsave(str(tmp_path / "cli.tif"), img)
    assert experimental_main(["--image", str(tmp_path / "module.npy"),
                              "--pretrained-checkpoint", ckpt, "--log", "0",
                              "--device", "cpu"]) == 0
    assert torch_cli(["--image", str(tmp_path / "cli.tif"), "--pretrained-checkpoint", ckpt,
                      "--experimental", "--log", "0", "--device", "cpu"]) == 0
    assert not (tmp_path / "module_instance_mask.tif").exists()
    np.testing.assert_array_equal(np.load(tmp_path / "module_instance_mask.npy"),
                                  imread(str(tmp_path / "cli_instance_mask.tif")))
