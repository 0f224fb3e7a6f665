"""Config system: defaults, yaml BASE inheritance, overrides, freezing."""

import pytest

from qfa_tpu.config import ConfigNode, default_config, load_config


def test_defaults_match_reference_keys():
    cfg = default_config()
    assert cfg.DATA.BATCH_SIZE == 500
    assert cfg.DATA.LAMMIN == 1030.0
    assert cfg.DATA.LAMMAX == 1600.0
    assert cfg.DATA.LOGLAM_DELTA == 1e-4
    assert cfg.MODEL.NH == 8
    assert cfg.MODEL.TAU == "becker"
    assert cfg.TRAIN.NEPOCHS == 500
    assert cfg.TRAIN.LEARNING_RATE == 1e-3
    assert cfg.TRAIN.WEIGHT_DECAY == 0.1
    assert cfg.TRAIN.DECAY_ALPHA == 0.9
    assert cfg.TRAIN.DECAY_STEP == 10
    # the keys of the removed kernel engines are gone; storage stays f32
    assert "MXU_BF16" not in cfg.TRAIN and "ENGINE" not in cfg.TRAIN
    assert cfg.TRAIN.BF16_PLANES is False


def test_yaml_base_inheritance(tmp_path):
    (tmp_path / "base.yaml").write_text("MODEL:\n  NH: 12\nTRAIN:\n  NEPOCHS: 7\n")
    (tmp_path / "child.yaml").write_text(
        "BASE: ['base.yaml']\nTRAIN:\n  NEPOCHS: 9\n"
    )
    cfg = load_config(str(tmp_path / "child.yaml"))
    assert cfg.MODEL.NH == 12  # inherited from base
    assert cfg.TRAIN.NEPOCHS == 9  # overridden by child
    assert cfg.DATA.BATCH_SIZE == 500  # default survives


def test_opts_override_with_type_coercion():
    cfg = load_config(opts=["DATA.BATCH_SIZE", "128", "MODEL.TAU", "fg",
                            "TRAIN.LEARNING_RATE", "0.5",
                            "DATA.VALIDATION", "true"])
    assert cfg.DATA.BATCH_SIZE == 128 and isinstance(cfg.DATA.BATCH_SIZE, int)
    assert cfg.MODEL.TAU == "fg"
    assert cfg.TRAIN.LEARNING_RATE == 0.5
    assert cfg.DATA.VALIDATION is True


def test_frozen_config_rejects_writes():
    cfg = load_config()
    with pytest.raises(AttributeError):
        cfg.MODEL.NH = 4
    cfg2 = cfg.clone()  # clones are writable again
    cfg2.MODEL.NH = 4
    assert cfg2.MODEL.NH == 4 and cfg.MODEL.NH == 8


def test_dump_roundtrip(tmp_path):
    cfg = load_config(opts=["MODEL.NH", "5"])
    path = tmp_path / "dumped.yaml"
    path.write_text(cfg.dump())
    cfg2 = load_config(str(path))
    assert cfg2.MODEL.NH == 5
    assert cfg2.to_dict() == cfg.to_dict()


def test_bad_opts_rejected():
    with pytest.raises(ValueError):
        load_config(opts=["MODEL.NH"])  # dangling key


def test_cli_flags_explicit_falsy_values():
    """Explicit falsy flags (--snr_min 0, --validation False) must override
    the defaults (regression: `if value:` dropped them silently)."""
    from qfa_tpu.cli import build_parser
    from qfa_tpu.config import get_config

    args = build_parser().parse_args(
        ["--snr_min", "0", "--z_min", "0", "--validation", "False",
         "--num_mask", "0"]
    )
    cfg = get_config(args)
    assert cfg.DATA.SNR_MIN == 0.0
    assert cfg.DATA.Z_MIN == 0.0
    assert cfg.DATA.VALIDATION is False
    assert cfg.DATA.NUM_MASK == 0
