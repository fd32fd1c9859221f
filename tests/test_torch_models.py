"""biahub_tpu_torch's networks and checkpoint loaders against biahub_tpu's.

Weights come from the reference's torch twin (``models/torch_twin.py``,
seeded; GRN's zero-initialised gamma and beta and BatchNorm's statistics
randomised so they count), go through the reference's converter into flax
variables, and are carried back into the port's network by
``state_dict_from_flax`` / ``cpnet_state_dict_from_flax``; the reference's
flax model and the port's network then run on the same numpy input:
UNeXt2 and UNet25D within 1e-5 * max|ref| (tests/test_unext2.py's
tolerance), CPnet within 2e-4 absolute and its style within 1e-5
(tests/test_cpnet.py's). The loaders take the twin's bare and Lightning
checkpoints to the same tensors the reference's converter reads (carried
back), refuse a VisCy/timm schema and a file without CPnet's marker key
with the reference's messages, and infer CPnet's config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biahub_tpu.models import convert as reference_convert
from biahub_tpu.models.cpnet import CPnet as FlaxCPnet
from biahub_tpu.models.torch_twin import TorchCPnet, TorchUNet25D, TorchUNeXt2
from biahub_tpu.models.unet25d import UNet25D as FlaxUNet25D
from biahub_tpu.models.unext2 import UNeXt2 as FlaxUNeXt2
from biahub_tpu_torch.models import convert
from biahub_tpu_torch.models.cpnet import CPnet
from biahub_tpu_torch.models.unet25d import UNet25D
from biahub_tpu_torch.models.unext2 import UNeXt2

UNEXT2 = dict(in_channels=1, out_channels=2, in_stack_depth=5, encoder_blocks=(1, 1, 2, 1),
              dims=(8, 16, 32, 64), decoder_conv_blocks=2, stem_kernel_size=(5, 4, 4))
NBASE = (2, 8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one torch thread: the suite runs several test
    processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def twin_weights(twin: torch.nn.Module, seed: int) -> dict:
    """The twin's state dict with GRN parameters and BatchNorm statistics
    drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in twin.state_dict().items():
        if key.endswith(("grn.gamma", "grn.beta", "running_mean")):
            value = torch.rand(value.shape, generator=gen) - 0.5
        elif key.endswith("running_var"):
            value = 0.5 + 1.5 * torch.rand(value.shape, generator=gen)
        state[key] = value
    return state


def assert_close(got: np.ndarray, want: np.ndarray, rel: float) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def run(module: torch.nn.Module, x: np.ndarray):
    with torch.no_grad():
        return module.eval()(torch.from_numpy(x))


def flax_run(model, variables, x: np.ndarray):
    return jax.jit(model.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))


@pytest.mark.parametrize("cfg, shape", [
    (UNEXT2, (2, 1, 5, 64, 64)),
    (dict(UNEXT2, in_stack_depth=10, out_stack_depth=3, encoder_blocks=(1, 1, 1, 1),
          decoder_conv_blocks=1), (1, 1, 10, 32, 64)),
], ids=["default", "deeper_stack_narrow_output"])
def test_unext2_holds_the_flax_model(cfg, shape):
    torch.manual_seed(1)
    variables = reference_convert.torch_state_dict_to_flax(
        twin_weights(TorchUNeXt2(**cfg), seed=2))
    x = np.random.default_rng(2).standard_normal(shape, dtype=np.float32)
    want = np.asarray(flax_run(FlaxUNeXt2(**cfg), variables, x))
    model = convert.load_into(UNeXt2(**cfg), convert.state_dict_from_flax(variables))
    assert_close(run(model, x).numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        run(model, x[..., :30])


def test_unet25d_holds_the_flax_model():
    cfg = dict(in_channels=2, out_channels=2, in_stack_depth=5, out_stack_depth=3,
               num_filters=(4, 8, 16))
    torch.manual_seed(3)
    variables = reference_convert.torch_state_dict_to_flax(TorchUNet25D(**cfg).state_dict())
    x = np.random.default_rng(3).standard_normal((1, 2, 5, 32, 48), dtype=np.float32)
    want = np.asarray(flax_run(FlaxUNet25D(**cfg), variables, x))
    model = convert.load_into(UNet25D(**cfg), convert.state_dict_from_flax(variables))
    assert_close(run(model, x).numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        run(model, x[..., :30])


@pytest.mark.parametrize("style_on, shape", [(True, (2, 2, 64, 64)), (False, (1, 2, 48, 80))],
                         ids=["style", "odd_no_style"])
def test_cpnet_holds_the_flax_model(style_on, shape):
    torch.manual_seed(4)
    variables = reference_convert.torch_cpnet_to_flax(
        twin_weights(TorchCPnet(nbase=NBASE, style_on=style_on), seed=5))
    x = np.random.default_rng(5).standard_normal(shape, dtype=np.float32)
    want_y, want_style = flax_run(FlaxCPnet(nbase=NBASE, style_on=style_on), variables, x)
    model = convert.load_into(CPnet(nbase=NBASE, style_on=style_on),
                              convert.cpnet_state_dict_from_flax(variables))
    got_y, got_style = run(model, x)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got_style.numpy(), np.asarray(want_style), atol=1e-5, rtol=0)


def test_loaders_read_the_reference_checkpoints(tmp_path):
    torch.manual_seed(7)
    twin = TorchUNeXt2(**UNEXT2).eval()
    state = twin.state_dict()
    bare, lightning = tmp_path / "bare.pth", tmp_path / "lightning.ckpt"
    torch.save(state, bare)
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 3},
               lightning)
    x = np.random.default_rng(8).standard_normal((1, 1, 5, 32, 32), dtype=np.float32)
    want = run(twin, x).numpy()
    for path in (bare, lightning):
        loaded = convert.load_torch_checkpoint(str(path))
        carried = convert.state_dict_from_flax(reference_convert.load_torch_checkpoint(str(path)))
        assert loaded.keys() == carried.keys()
        for key in loaded:
            assert torch.equal(loaded[key], carried[key]), key
        model = convert.load_into(UNeXt2(**UNEXT2), loaded)
        assert_close(run(model, x).numpy(), want, 1e-6)

    foreign = tmp_path / "viscy.ckpt"
    torch.save({"state_dict": {"model.encoder.stages.0.blocks.1.conv_dw.weight":
                               torch.zeros(8, 1, 7, 7)}}, foreign)
    messages = []
    for loader in (convert.load_torch_checkpoint, reference_convert.load_torch_checkpoint):
        with pytest.raises(ValueError) as info:
            loader(str(foreign))
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "VisCy/timm" in messages[0]


def test_cpnet_loader_and_config(tmp_path):
    torch.manual_seed(9)
    twin = TorchCPnet(nbase=NBASE).eval()
    path = tmp_path / "cpnet.pt"
    torch.save({"state_dict": {f"net.{k}": v for k, v in twin.state_dict().items()}}, path)
    state, config = convert.load_cpnet_checkpoint(str(path))
    ref_vars, ref_config = reference_convert.load_cpnet_checkpoint(str(path))
    assert config == ref_config == {"nbase": NBASE, "nout": 3, "sz": 3}
    carried = convert.cpnet_state_dict_from_flax(ref_vars)
    assert state.keys() == carried.keys()
    for key in state:
        assert torch.equal(state[key], carried[key]), key
    x = np.random.default_rng(10).standard_normal((1, 2, 32, 48), dtype=np.float32)
    got = run(convert.load_into(CPnet(**config), state), x)[0]
    np.testing.assert_allclose(got.numpy(), run(twin, x)[0].numpy(), atol=1e-6, rtol=0)

    bogus = tmp_path / "bogus.pt"
    torch.save({"layer.weight": torch.zeros(3)}, bogus)
    messages = []
    for loader in (convert.load_cpnet_checkpoint, reference_convert.load_cpnet_checkpoint):
        with pytest.raises(ValueError) as info:
            loader(str(bogus))
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "cellpose-schema" in messages[0]
