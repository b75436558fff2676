"""The port against the committed reference goldens (tests/goldens/), at the
tolerances tests/test_model_parity.py holds the JAX package to: 1e-4 on the
backbone and encoder outputs, rtol 1e-4 / atol 2e-4 on the greedy step logits,
identical greedy tokens."""

import os

import numpy as np
import pytest
import torch

from texocr_tpu.checkpoint import convert_torch_state_dict
from texocr_tpu_torch.checkpoint import load_state, state_dict_from_jax
from texocr_tpu_torch.config import ModelConfig
from texocr_tpu_torch.models import OCRModel, greedy_decode

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens")
STATE = os.path.join(GOLDEN, "model_state.npz")

CONFIG = {
    "img_size": (48, 128), "patch_size": 16, "vocab_size": 50, "max_length": 32,
    "glu": True, "bos_token": 48, "eos_token": 47, "trg_pad_idx": 49, "dtype": "float32",
    "encoder": {"n_channels": 1, "embed_dim": 64, "num_layers": 2, "heads": 2,
                "resnet_depths": (1, 1, 1), "resnet_channels": (128, 128, 128),
                "stem_channels": 32},
    "decoder": {"embed_dim": 64, "num_layers": 2, "heads": 2, "cross_attend": True,
                "dropout": 0.0, "exp_factor": 4},
}


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "model_io.npz"))


@pytest.fixture(scope="module")
def model():
    m = OCRModel(ModelConfig.from_dict(CONFIG), device="cpu")
    m.load_state_dict(load_state(STATE), strict=True)
    return m


def _images(golden):
    return torch.from_numpy(golden["images"]).permute(0, 2, 3, 1).contiguous()


def test_state_dict_keys_are_the_reference_keys(model):
    want = np.load(STATE)
    assert sorted(model.state_dict()) == sorted(want.files)
    assert len(want.files) == 144


def test_pth_checkpoint_loads(tmp_path):
    state = load_state(STATE)
    path = tmp_path / "model.pth"
    torch.save({"model_state_dict": state, "epoch": 3}, str(path))
    loaded = load_state(str(path))
    assert sorted(loaded) == sorted(state)
    for key in state:
        assert torch.equal(loaded[key], state[key])


def test_state_dict_from_jax_inverts_the_shim():
    ref = dict(np.load(STATE))
    tree = convert_torch_state_dict(ref, num_encoder_layers=2, num_decoder_layers=2,
                                    resnet_depths=(1, 1, 1), glu=True)
    back = state_dict_from_jax(tree)
    assert sorted(back) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


def test_backbone_matches_golden(model, golden):
    with torch.no_grad():
        feats = model.encoder.patch_embed.backbone_net(_images(golden))
    np.testing.assert_allclose(feats.permute(0, 3, 1, 2).numpy(), golden["backbone_feats"],
                               rtol=1e-4, atol=1e-4)


def test_encoder_matches_golden(model, golden):
    with torch.no_grad():
        enc = model.encode(_images(golden))
    np.testing.assert_allclose(enc.numpy(), golden["enc_out"], rtol=1e-4, atol=1e-4)


def test_greedy_decode_matches_golden(model, golden):
    with torch.no_grad():
        enc = model.encode(_images(golden))
    steps = golden["greedy_step_logits"].shape[1]
    tokens, logits = greedy_decode(model, enc, bos_token=48, eos_token=-1, pad_token=49,
                                   max_len=steps, return_logits=True)
    np.testing.assert_allclose(logits.numpy(), golden["greedy_step_logits"], rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(tokens.numpy(), golden["greedy_tokens"][:, 1:])
