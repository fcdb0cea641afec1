"""The training loop's TensorBoard image panels (``skoots_tpu_torch/train/viz.py``
and ``train/engine.py::write_panels``) against the JAX package's
(``skoots_tpu/train/viz.py`` and the dense loop's ``_panel_forward``).

Tolerances: the two grids are compared as the uint8 images the writers
log, within 1 of 255 per channel: the f32 panels agree to a few ulps (the
port's HSV -> RGB is matplotlib's arithmetic in numpy; the model forward
sums in another order), and a value that close to a multiple of 1/255 can
truncate to either side.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.models.spatial_embedding import split_output
from skoots_tpu.ops.embed2prob import baked_embed_to_prob as jax_embed_to_prob
from skoots_tpu.ops.vec2embed import vector_to_embedding as jax_vec2embed
from skoots_tpu.train import viz as jax_viz
from skoots_tpu_torch import config as C
from skoots_tpu_torch.models import cfg_to_model, load_flax_params
from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask
from skoots_tpu_torch.train import viz
from skoots_tpu_torch.train.engine import panel_forward, train
from skoots_tpu_torch.train.sigma import init_sigma
from skoots_tpu_torch.utils.synthetic import make_tubes

ROOT = Path(__file__).resolve().parent.parent
T = torch.from_numpy
TINY_MODEL = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
              "KERNEL_SIZE": 3, "DTYPE": "float32"}
SHAPE = (16, 16, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RecordingWriter:
    """The two ``SummaryWriter`` calls the training loop makes."""

    def __init__(self):
        self.images, self.scalars = [], []

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images.append((tag, np.array(img), step, dataformats))

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def _panel_arrays(rng, b=2, shape=SHAPE):
    x, y, z = shape
    return dict(images=rng.standard_normal((b, x, y, z, 1)).astype(np.float32),
                masks=(rng.random((b, x, y, z, 1)) > 0.6).astype(np.float32),
                vector=rng.standard_normal((b, x, y, z, 3)).astype(np.float32),
                embed_prob=rng.random((b, x, y, z, 1)).astype(np.float32),
                predicted_skeleton=rng.standard_normal((b, x, y, z, 1)).astype(np.float32),
                gt_skeleton=(rng.random((b, x, y, z, 1)) > 0.8).astype(np.float32))


def _logged(module, arrays, **kw):
    w = RecordingWriter()
    grid = module.write_progress(w, "Train", 3, **arrays, **kw)
    (tag, img, step, fmt), = w.images
    assert (tag, step, fmt) == ("Train", 3, "HWC") and img.dtype == np.uint8
    return grid, img


@pytest.mark.parametrize("optional", ["both", "none"])
def test_write_progress_grid_matches_jax(optional):
    """Same seeded arrays, same panels in the same order: the logged uint8
    images within 1 of 255 per channel, of the same height and width."""
    arrays = _panel_arrays(np.random.default_rng(0))
    if optional == "none":
        arrays.pop("predicted_skeleton")
        arrays.pop("gt_skeleton")
    got_grid, got = _logged(viz, arrays)
    want_grid, want = _logged(jax_viz, arrays)
    rows = SHAPE[0] * (7 if optional == "both" else 5)
    assert got.shape == want.shape == (rows, SHAPE[1], 3)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    np.testing.assert_allclose(got_grid, want_grid, rtol=0, atol=1e-6)


def test_hsv_to_rgb_matches_matplotlib():
    """Every hue sector, both ends of the wheel, grey (s = 0), f32 and f64."""
    mcolors = pytest.importorskip("matplotlib.colors")
    rng = np.random.default_rng(1)
    for dt in (np.float32, np.float64):
        hsv = rng.random((40, 30, 3)).astype(dt)
        hsv[0, :7, 0] = np.arange(7) / 6  # sector edges, h = 1 included
        hsv[1, :5, 1] = 0.0
        got, want = viz.hsv_to_rgb(hsv), mcolors.hsv_to_rgb(hsv)
        assert got.dtype == want.dtype == dt
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    flow = rng.standard_normal((24, 20, 2)).astype(np.float32)
    assert int(np.abs(viz.flow_to_image(flow).astype(int)
                      - jax_viz.flow_to_image(flow).astype(int)).max()) <= 1


def _tiny_batch(b=1, shape=SHAPE):
    img, lab, sk = make_tubes(shape, 2, radius=3, seed=9)
    packed = pack_skeletons(sk)
    baked = bake_skeleton(T(lab), packed, (1.0, 1.0, 3.0)).numpy()
    skel = skeleton_to_mask(packed, shape, 3, 3).numpy()
    one = {"image": ((img.astype(np.float32) - 60) / 30)[..., None],
           "masks": (lab > 0).astype(np.float32)[..., None], "baked": baked,
           "skele_masks": skel[..., None]}
    return {k: np.stack([v] * b) for k, v in one.items()}


def test_panels_from_the_same_weights_match_jax():
    """JAX's ``_panel_forward`` (eval forward, split, embedding, probability
    at sigma(e)) and the port's ``panel_forward`` from the same weights on
    the same batch, through each package's ``write_progress``."""
    update = {"MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}}
    jc = jax_defaults()
    jc.merge_from_dict(update)
    tc = C.merge_from_dict(C.get_cfg_defaults(), update)
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=SHAPE)
    model = load_flax_params(cfg_to_model(tc), jax.tree_util.tree_map(np.asarray, jparams))
    batch = _tiny_batch(b=2)
    epoch = 1
    sigma = init_sigma(tc)(epoch)

    out = jmodel.apply(jparams, jnp.asarray(batch["image"]), deterministic=True)
    jvec, jskel, _ = split_output(out)
    jprob = jax_embed_to_prob(jax_vec2embed(jnp.asarray([8.0, 8.0, 4.0]), jvec),
                              jnp.asarray(batch["baked"]), jnp.asarray(sigma))
    want_grid, want = _logged(jax_viz, dict(
        images=batch["image"], masks=batch["masks"], vector=np.asarray(jvec),
        embed_prob=np.asarray(jprob), predicted_skeleton=np.asarray(jskel),
        gt_skeleton=batch["skele_masks"]))

    model.train()
    vec, skel, prob = panel_forward(model, {k: T(v) for k, v in batch.items()}, sigma,
                                    (8.0, 8.0, 4.0))
    assert model.training  # put back as it was
    got_grid, got = _logged(viz, dict(
        images=batch["image"], masks=batch["masks"], vector=vec.numpy(),
        embed_prob=prob.numpy(), predicted_skeleton=skel.numpy(),
        gt_skeleton=batch["skele_masks"]))
    assert got.shape == want.shape
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    np.testing.assert_allclose(got_grid, want_grid, rtol=0, atol=1e-4)


def test_dense_train_writes_one_train_image_an_epoch(tmp_path):
    """A 2-epoch f32 dense ``train`` on the CPU: exactly one ``"Train"``
    image an epoch, logged after the epoch's scalars, of the height and
    width JAX's ``write_progress`` gives the same batch."""
    cfg = C.merge_from_dict(C.get_cfg_defaults(), {
        "MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
        "TRAIN": {"NUM_EPOCHS": 2, "SAVE_PATH": str(tmp_path), "SAVE_INTERVAL": 10,
                  "LOSS_SKELETON_START_EPOCH": -1}})
    batch = {k: T(v) for k, v in _tiny_batch().items()}
    writer = RecordingWriter()
    train(cfg, lambda e: iter([batch]), "cpu", writer=writer)
    images = [(tag, step) for tag, _, step, _ in writer.images]
    assert images == [("Train", 0), ("Train", 1)]
    _, want = _logged(jax_viz, dict(
        images=batch["image"].numpy(), masks=batch["masks"].numpy(),
        vector=np.zeros((*batch["image"].shape[:-1], 3), np.float32),
        embed_prob=batch["masks"].numpy(), predicted_skeleton=batch["masks"].numpy(),
        gt_skeleton=batch["skele_masks"].numpy()))
    for _, img, _, fmt in writer.images:
        assert fmt == "HWC" and img.dtype == np.uint8 and img.shape == want.shape
    assert {tag for tag, _, _ in writer.scalars} >= {"Loss/loss", "lr"}


def test_viz_imports_no_matplotlib():
    """Nothing in the port's viz reaches matplotlib, at import or at call."""
    tree = ast.parse((ROOT / "skoots_tpu_torch" / "train" / "viz.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not any(str(m).split(".")[0] == "matplotlib" for m in names), names
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import numpy as np\n"
            "from skoots_tpu_torch.train.viz import write_progress\n"
            "a = np.random.default_rng(0).random((1, 8, 8, 4, 3)).astype(np.float32)\n"
            "g = write_progress(None, 'Train', 0, a[..., :1], a[..., 1:2], a, a[..., 2:])\n"
            "assert g.shape == (40, 8, 3)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _event_images(log_dir: Path) -> list:
    """(tag, step, PNG bytes) of every image summary in a TensorBoard event
    file: TFRecords of a length, its CRC, an ``Event``, the event's CRC."""
    from tensorboard.compat.proto.event_pb2 import Event

    out = []
    for path in sorted(log_dir.glob("events.out.tfevents.*")):
        data, pos = path.read_bytes(), 0
        while pos < len(data):
            n = int.from_bytes(data[pos:pos + 8], "little")
            event = Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 16 + n
            for v in event.summary.value:
                if v.HasField("image"):
                    out.append((v.tag, event.step, v.image.encoded_image_string))
    return out


def test_training_writer_encodes_panels_without_pillow(rng, tmp_path, monkeypatch):
    """The training CLI's writer (``train/cli.py::summary_writer``) encodes
    a panel as PNG itself: with Pillow blocked (the card's machine may have
    none; torch's image summary imports it) the panel reaches the event
    file, and decodes to the uint8 grid ``write_progress`` logged."""
    from skoots_tpu_torch.train.cli import summary_writer

    monkeypatch.setitem(sys.modules, "PIL", None)
    writer = summary_writer(str(tmp_path))
    grid = viz.write_progress(writer, "Train", 3, **_panel_arrays(rng))
    writer.close()
    monkeypatch.delitem(sys.modules, "PIL")
    from PIL import Image
    import io

    (tag, step, png), = _event_images(tmp_path)
    assert (tag, step) == ("Train", 3)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  (grid * 255).astype(np.uint8))
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(viz.png_bytes(img)))), img)
    with pytest.raises(ValueError):
        summary_writer(str(tmp_path)).add_image("Train", img[..., 0], 0, dataformats="HW")
