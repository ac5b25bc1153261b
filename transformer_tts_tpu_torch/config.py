"""Hyper-parameters for the PyTorch port.

The port's own copy of the JAX package's config contract
(transformer_tts_tpu/config.py): the same defaults dict, ``HParams``
(``from_file``, ``override``, ``as_dict``, ``snapshot``), ``load_hparams`` and
``is_nar_model``, so an ``hparams.py`` written for one package loads in
the other. Keys that only the JAX package reads (``mesh_shape``,
``prng_impl``, ...) are kept so such files load unchanged; the port
ignores them. ``log_config`` reports torch and the CUDA device.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import sys
from typing import Any, Dict, Optional


# Defaults injected when absent, mirroring the reference ``fill_variables``
# (utils/utils.py:184-201) plus the knobs every training script assumes
# (utils/default.yaml:1-103 and the train_*.py argument plumbing).
_DEFAULTS: Dict[str, Any] = {
    # --- general -----------------------------------------------------------
    "architecture": "text-mel",       # text-mel | mel-mel | text-mel-mel
    "model": "Fastspeech2",           # Fastspeech2 | Transformer
    "vocab_size": 152,
    "mel_dim": 80,
    "amp": True,                      # bf16 autocast (no loss scaler)
    "tail_alignment": "_alignment",
    "output_type": None,
    "num_group": None,
    # --- scripts / data ----------------------------------------------------
    "train_script": None,
    "test_script": None,
    "spm_model": None,
    "mean_file": None,
    "var_file": None,
    "lengths_file": None,
    "log_dir": "logs",
    "save_dir": "checkpoints",
    # --- resume ------------------------------------------------------------
    "loaded_epoch": None,
    "loaded_dir": None,
    "pretrain_model": None,
    # mel-mel: train the student from a PREGENERATED teacher corpus
    # (cli/teacher_forcing --suffix <this>, the reference's actual
    # generate_teacher_forcing.py -> train_fastspeech2_dev.py workflow)
    # instead of re-running the frozen teacher every step. ~2x the
    # mel-mel step throughput (no teacher forward in the step).
    "teacher_suffix": None,
    # --- optimizer ---------------------------------------------------------
    "optimizer": "Noam",              # Noam | RAdam | AdamW
    "warmup_step": 4000,
    "warmup_factor": 1.0,
    "learning_rate": 1e-3,            # used by RAdam/AdamW paths
    "max_seqlen": None,               # frame budget batching (XOR batch_size)
    "sort_by_length": True,           # length-homogeneous frame-budget
                                      # batches (False = the reference's
                                      # corpus-order packing)
    "batch_size": None,
    "max_epoch": 200,
    "save_per_epoch": 50,
    "clip": 1.0,
    "accum_grad": 1,
    "seed": 77,
    # Apply the reference's init_weight scheme (utils/utils.py:153-177,
    # applied by every reference training script, e.g. train.py:103,
    # train_fastspeech2.py:399): Kaiming-normal conv kernels with zero
    # bias. Default True for training-dynamics parity; False keeps flax
    # defaults (lecun_normal kernels, zero bias), a documented deviation
    # (PARITY.md §Deliberate deviations).
    "reference_init": True,
    # Guided-attention loss on the AR teacher's cross-attention
    # (Tachibana et al. 2017 §3.3 diagonal prior; beyond-parity opt-in).
    # Weight 0 = off (reference behavior). Useful when the corpus lets
    # teacher-forced training solve next-frame prediction without
    # localized attention (the duration-extraction bootstrap then has
    # nothing to extract — measured on egs/full_pipeline's glide
    # corpus: oracle best-head duration error 2.8 frames/phone).
    "guided_attention_weight": 0.0,
    "guided_attention_sigma": 0.3,
    # dropout-mask PRNG of the JAX package (not read by the port)
    "prng_impl": "rbg",
    # --- encoder -----------------------------------------------------------
    "encoder_type": "transformer",    # transformer | conformer
    "d_model_encoder": 384,
    "n_layer_encoder": 6,
    "n_head_encoder": 4,
    "ff_conv_kernel_size_encoder": 5,
    "concat_after_encoder": False,
    # --- decoder -----------------------------------------------------------
    "decoder_type": "transformer",    # transformer | conformer | tacotron2
    "d_model_decoder": 384,
    "n_layer_decoder": 6,
    "n_head_decoder": 4,
    "ff_conv_kernel_size_decoder": 1,
    "concat_after_decoder": False,
    "postnet_pred": True,
    "reduction_rate": 2,
    # --- dropouts ----------------------------------------------------------
    "dropout": 0.1,
    "dropout_prenet": 0.5,
    "dropout_postnet": 0.5,
    "dropout_variance_adaptor": 0.5,
    # --- losses ------------------------------------------------------------
    "positive_weight": 5.0,           # stop-token BCE pos_weight
    "channel_wise": False,
    "channel_weight": None,
    "use_ssim": False,
    "use_cosine_emb_loss": False,
    "time_weight": None,
    # --- acoustic ----------------------------------------------------------
    "pitch_pred": True,
    "energy_pred": True,
    "f0_min": 71.0,
    "f0_max": 795.8,
    "energy_min": 0.0,
    "energy_max": 315.0,
    # beyond-parity opt-in: when all four stats are set, the pitch /
    # energy PREDICTORS work in standardized units ((v - mean) / std,
    # losses included) and are de-standardized before the bucketized
    # embeddings. This balances the multi-task loss — the reference's
    # raw-Hz f0 L1 otherwise dominates loss_total by the raw-scale
    # factor (measured ~10:1, docs/LEARNING_DEMO.md) — and removes the
    # initial transient while the predictor climbs to O(200 Hz).
    # cli.prepare_data writes the corpus values to variance_stats.json.
    # Default None = exact reference semantics.
    "f0_mean": None,
    "f0_std": None,
    "energy_mean": None,
    "energy_std": None,
    "nbins": 256,
    "log_offset": 1.0,
    "accent_emb": False,
    "gender_emb": False,
    "use_hop": False,
    # --- variance adaptor --------------------------------------------------
    "use_rnn_length": False,
    "use_pos": False,
    "p_scheduled_sampling": 0.0,
    # --- multi-speaker -----------------------------------------------------
    "is_multi_speaker": False,
    "num_speakers": None,
    "spk_emb_type": None,             # speaker_id | x_vector
    "spk_emb_dim": None,
    "spk_emb_architecture": "",       # subset of {encoder, middle, decoder}
    "different_spk_emb_samespeaker": False,
    "spk_emb_vers": 1,
    # --- GST ---------------------------------------------------------------
    "gst": False,
    # --- SQ-VAE / VQ -------------------------------------------------------
    "use_sq_vae": False,
    "vq_code": False,
    # --- post-processing (mel-mel research line) ---------------------------
    "version": None,                  # PostLowEnergy version 1-10
    "mel_dim_post": None,             # defaults to mel_dim
    "n_layer_post_model": 6,
    "ff_conv_kernel_size_post": 5,
    "concat_after_post": True,
    "post_conformer": False,
    "phone_embed": False,
    "concat": False,
    "semantic_mask": False,
    "semantic_mask_phone": False,
    "mask_probability": 0.06,
    "mask": False,
    "fix_mask": None,
    "speaker_emb": False,
    "ctc_out": False,
    # CTC auxiliary loss on a mid-decoder tap (legacy trainer,
    # train_Fastspeech2.py:168,220-224; weight 0.2, blank 0)
    "CTC_training": False,
    "spk_emb_postprocess_type": None,
    "spk_emb_dim_postprocess": None,
    "intermediate_layers_out": None,
    # --- neural vocoder (beyond parity; the reference relies on an
    # external vocoder — see vocoder/__init__.py) ---------------------------
    "vocoder_type": "hifigan",                   # hifigan | istft
    "vocoder_upsample_rates": (8, 8, 2, 2),      # prod == hop_length
    "vocoder_upsample_kernel_sizes": (16, 16, 4, 4),
    # istft (Vocos-style) variant: ConvNeXt backbone at frame rate
    "vocoder_istft_n_fft": 1024,
    "vocoder_convnext_channels": 512,
    "vocoder_convnext_layers": 8,
    "vocoder_convnext_mlp": 1536,
    "vocoder_channels": 512,
    "vocoder_resblock_kernel_sizes": (3, 7, 11),
    "vocoder_resblock_dilations": ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    "vocoder_upsample_mode": "subpixel",         # subpixel | transposed
    "vocoder_periods": (2, 3, 5, 7, 11),
    "vocoder_num_scales": 3,
    "vocoder_segment_size": 8192,
    "vocoder_lr": 2e-4,
    "vocoder_lr_decay": 0.999,
    "vocoder_lr_decay_steps": 1000,
    "vocoder_adam_b1": 0.8,
    "vocoder_adam_b2": 0.99,
    "vocoder_lambda_mel": 45.0,
    "vocoder_lambda_fm": 2.0,
    # --- misc --------------------------------------------------------------
    "save_attention_per_step": 1000,
    # TensorBoard IMAGE summaries (attention maps + pred/target mels)
    # every save_attention_per_step steps — the reference's intended
    # visualization workflow (train.py:227-234, commented there); costs
    # one extra collect_attn forward per dump, so opt-in
    "tb_images": False,
    # --- accelerator-specific (no reference equivalent) --------------------
    "length_buckets": (128, 256, 512, 768, 1024, 1536, 2048),
    "text_buckets": (32, 64, 96, 128, 192, 256),
    # flash-attention kernel: attention over at least FLASH_MIN_KEY_LEN
    # keys goes to it (ops/attention.py); O(T) score storage, not O(T^2)
    "use_flash_attention": True,
    # the port's training reads remat (the FastSpeech 2 forward
    # recomputed in the backward), log_every, debug_nans (anomaly
    # detection and non-finite-output hooks), profile_dir (a
    # torch.profiler trace) and num_workers (the loader's threads);
    # mesh_shape is kept so the JAX package's hparams files load here
    "mesh_shape": None,
    "remat": False,
    "debug_nans": False,
    "log_every": 1,
    "profile_dir": None,
    "num_workers": 8,
}


def _import_from_file(path: str):
    """Import a Python config file as an anonymous module."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"hparams file not found: {path}")
    name = "_tts_hparams_" + os.path.basename(path).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class HParams:
    """A plain hparams namespace with reference-compatible defaults;
    attribute access (``hp.vocab_size``) is the API."""

    def __init__(self, **overrides: Any):
        for key, value in _DEFAULTS.items():
            setattr(self, key, value)
        self._source_file: Optional[str] = None
        for key, value in overrides.items():
            setattr(self, key, value)
        self._validate()

    @classmethod
    def from_file(cls, path: str, **overrides: Any) -> "HParams":
        """Load a user ``.py`` hparams file, then ``overrides``."""
        module = _import_from_file(path)
        values = {
            k: v for k, v in vars(module).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(sys))
        }
        values.update(overrides)
        hp = cls(**values)
        hp._source_file = os.path.abspath(path)
        return hp

    def _validate(self) -> None:
        if getattr(self, "spkr_emb", None) is not None:
            raise ValueError(
                "hp.spkr_emb is deprecated; use hp.spk_emb_architecture")
        if self.batch_size is not None and self.max_seqlen is not None:
            raise ValueError("set batch_size XOR max_seqlen, not both")
        if self.spk_emb_postprocess_type == "x_vector" \
                and self.spk_emb_dim_postprocess is None:
            self.spk_emb_dim_postprocess = 512
        if self.mel_dim_post is None:
            self.mel_dim_post = self.mel_dim

    def override(self, **kwargs: Any) -> "HParams":
        """CLI overrides (the reference's ``overwrite_hparams``); a later
        ``snapshot`` then writes the values, not the source file."""
        for key, value in kwargs.items():
            if value is not None:
                setattr(self, key, value)
        if kwargs:
            self._source_file = None
        return self

    def as_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def log_config(self) -> None:
        """Print PID, torch version, the CUDA device and every hparam."""
        import torch
        print(f"PID = {os.getpid()}")
        print(f"torch version = {torch.__version__} "
              f"(CUDA {torch.version.cuda})")
        if torch.cuda.is_available():
            print(f"device = {torch.cuda.get_device_name(0)} "
                  f"x {torch.cuda.device_count()}")
        else:
            print("device = no CUDA device")
        for key, value in sorted(self.as_dict().items()):
            print(f"{key} = {value}")

    def snapshot(self, save_dir: str) -> str:
        """Write the hparams file into ``save_dir`` as ``hparams.py``: a
        copy of the source file, or the values when there is none."""
        os.makedirs(save_dir, exist_ok=True)
        dest = os.path.join(save_dir, "hparams.py")
        if self._source_file is not None:
            if os.path.abspath(self._source_file) != os.path.abspath(dest):
                shutil.copyfile(self._source_file, dest)
        else:
            with open(dest, "w") as fh:
                for key, value in sorted(self.as_dict().items()):
                    fh.write(f"{key} = {value!r}\n")
        return dest

    def __repr__(self) -> str:
        return f"HParams({self.as_dict()!r})"


def load_hparams(path: str, **overrides: Any) -> HParams:
    return HParams.from_file(path, **overrides)


NAR_MODEL_NAMES = ("fastspeech2", "lightspeech", "sqfastspeech2",
                   "sq_fastspeech2", "fastspeech2_sq")


SQ_MODEL_NAMES = ("sqfastspeech2", "sq_fastspeech2", "fastspeech2_sq")


def is_nar_model(name: str) -> bool:
    """Non-autoregressive model families."""
    return name.lower() in NAR_MODEL_NAMES


def is_sq_model(name: str) -> bool:
    """The SQ-VAE FastSpeech 2 (``SQFastSpeech2``) and its aliases."""
    return name.lower() in SQ_MODEL_NAMES


def spk_arch(hp) -> tuple:
    """The places of ``encoder``, ``middle`` and ``decoder`` that
    ``hp.spk_emb_architecture`` names (a string such as
    "encoder,decoder" or a tuple), in that order."""
    named = hp.spk_emb_architecture or ""
    return tuple(s for s in ("encoder", "middle", "decoder") if s in named)
