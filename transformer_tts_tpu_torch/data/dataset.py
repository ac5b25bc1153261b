"""Script-file datasets (the port of ``parse_script`` and ``TTSDataset``,
transformer_tts_tpu/data/dataset.py:39-267, for FastSpeech 2 and the AR
Transformer-TTS).

Script format: ``mel_path|text_ids[|spk_or_accent[|gender]]`` per line,
pipe-separated, with space-separated integer ids. ``ScriptDataset`` gives
the text of each line and its conditioning (synthesis); ``TTSDataset``
adds, for training, the normalised mel and the sibling files of
``X.npy``: ``X_f0.npy`` and ``X_energy.npy`` when ``pitch_pred`` and
``energy_pred`` ask for them, and for FastSpeech 2 ``X{tail_alignment}
.npy`` (per-phone durations). For the AR models a zero go frame is put
before the mel and the length is rounded up to a multiple of
``reduction_rate`` (the collate pads the rest); they read no alignment,
and the AR step ignores f0 and energy, as in the JAX package. In the
discrete mode (``output_type``) ``X.npy`` holds (T, 2) int codes (a
(T,) file is one stream): loaded as int32 with no normalization and no
go frame, their length T; the siblings load as for mels.

Conditioning, read as the JAX dataset reads it (its :110-131), for
synthesis and training alike: ``hop_size`` (``use_hop``) from the mel's
file name, 1 for ``hop256``, 2 for ``hop160``, else 0; ``spk_emb``
(``is_multi_speaker``) the int speaker id of column 2
(``spk_emb_type = "speaker_id"``) or the sibling ``X_xvector.npy``
(``"x_vector"``); ``accent`` (``accent_emb``) the space-separated ids of
column 2 too, the same column as the speaker id, as in the JAX package;
``gender`` (``gender_emb``) the int of column 3; ``spk_emb_post`` (the
mel-to-mel student's ``spk_emb_postprocess_type``, the JAX file's
:130-134) the sibling ``X_xvector.npy`` (``"x_vector"``) or the int of
column 2 (``"speaker_id"``). SentencePiece text comes with a later slice.
For ``architecture = "mel-mel"`` with ``teacher_suffix`` (the
pregenerated teacher corpus of cli/teacher_forcing.py, the JAX file's
:163-172), a training sample also holds ``teacher_mel``, the normalised
``X{teacher_suffix}.npy``, and ``teacher_phone``,
``X{teacher_suffix}_phone.npy``, where that file exists.
``load_batch_samples`` reads a batch's mels with the native reader
(data/native.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from transformer_tts_tpu_torch.config import is_nar_model
from transformer_tts_tpu_torch.data.readers import Normalizer, load_mel


def parse_script(path: str) -> List[List[str]]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line:
                rows.append(line.split("|"))
    return rows


def encode_text(text: str) -> np.ndarray:
    return np.asarray([int(t) for t in text.split(" ")], np.int32)


class ScriptDataset:
    """The utterances of a script, as {mel_name, text, text_length} and
    the conditioning the hparams ask for."""

    def __init__(self, script_path: str, hp):
        if hp.spm_model is not None:
            raise NotImplementedError(
                "SentencePiece text comes with a later slice of the port; "
                "give space-separated ids")
        self.hp = hp
        self.rows = parse_script(script_path)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        hp = self.hp
        row = self.rows[idx]
        mel_name = row[0]
        text = encode_text(row[1].strip())
        sample = {"mel_name": mel_name, "text": text,
                  "text_length": len(text)}
        if hp.use_hop:
            sample["hop_size"] = (1 if "hop256" in mel_name
                                  else 2 if "hop160" in mel_name else 0)
        if hp.is_multi_speaker:
            if hp.spk_emb_type == "speaker_id":
                sample["spk_emb"] = int(row[2])
            elif hp.spk_emb_type == "x_vector":
                sample["spk_emb"] = np.load(
                    mel_name.replace(".npy", "_xvector.npy").strip())
            else:
                raise ValueError(
                    f"unknown spk_emb_type: {hp.spk_emb_type}")
        if hp.accent_emb:
            sample["accent"] = np.asarray(
                [int(t) for t in row[2].split(" ")], np.int32)
        if hp.gender_emb:
            sample["gender"] = int(row[3])
        if hp.spk_emb_postprocess_type == "x_vector":
            sample["spk_emb_post"] = np.load(
                mel_name.replace(".npy", "_xvector.npy"))
        elif hp.spk_emb_postprocess_type == "speaker_id":
            sample["spk_emb_post"] = int(row[2])
        return sample


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


class TTSDataset(ScriptDataset):
    """Training samples: text, the normalised mel and its length, and for
    FastSpeech 2 the alignment, f0 and energy targets the hparams ask
    for."""

    def __init__(self, script_path: str, hp, *,
                 pitch_pred: Optional[bool] = None,
                 energy_pred: Optional[bool] = None):
        super().__init__(script_path, hp)
        self.is_ar = not is_nar_model(hp.model)
        self.pitch_pred = hp.pitch_pred if pitch_pred is None else pitch_pred
        self.energy_pred = (hp.energy_pred if energy_pred is None
                            else energy_pred)
        self.normalizer = Normalizer(hp.mean_file, hp.var_file, hp.mel_dim)

    def _sibling(self, mel_name: str, tail: str, dtype) -> np.ndarray:
        return np.load(mel_name.replace(".npy", tail)).astype(dtype)

    def __getitem__(self, idx: int, *,
                    _preloaded_mel: Optional[np.ndarray] = None
                    ) -> Dict[str, Any]:
        hp = self.hp
        sample = super().__getitem__(idx)
        mel_name = sample["mel_name"]
        if _preloaded_mel is not None:
            sample["mel"] = _preloaded_mel
            sample["mel_length"] = _preloaded_mel.shape[0]
        elif hp.output_type:
            tokens = np.load(mel_name).astype(np.int32)
            sample["mel"] = tokens[:, None] if tokens.ndim == 1 else tokens
            sample["mel_length"] = sample["mel"].shape[0]
        else:
            mel = self.normalizer(load_mel(mel_name, hp.mel_dim))
            if self.is_ar:
                mel = np.concatenate(
                    [np.zeros((1, hp.mel_dim), np.float32), mel], axis=0)
                sample["mel_length"] = round_up(mel.shape[0],
                                                hp.reduction_rate)
            else:
                sample["mel_length"] = mel.shape[0]
            sample["mel"] = mel.astype(np.float32)
        if hp.architecture == "mel-mel" and hp.teacher_suffix:
            stem = mel_name.replace(".npy", hp.teacher_suffix)
            sample["teacher_mel"] = self.normalizer(
                load_mel(stem + ".npy", hp.mel_dim)).astype(np.float32)
            if os.path.exists(stem + "_phone.npy"):
                sample["teacher_phone"] = self._sibling(
                    mel_name, hp.teacher_suffix + "_phone.npy", np.float32)
        if not self.is_ar:
            sample["alignment"] = self._sibling(
                mel_name, hp.tail_alignment + ".npy", np.int32)
        if self.pitch_pred:
            sample["f0"] = self._sibling(mel_name, "_f0.npy", np.float32)
        if self.energy_pred:
            sample["energy"] = self._sibling(mel_name, "_energy.npy",
                                             np.float32)
        return sample

    def load_batch_samples(self, indices, n_threads: int = 8):
        """The samples of ``indices``, their mels read and normalised by
        the native reader in one call (data/native.py) and the rest by
        ``__getitem__``. The AR models (the go frame), the discrete mode
        and containers other than npy and HTK go through ``__getitem__``
        whole, as does a row the reader refuses or one that fills its
        buffer (it may be cut). The mels are views of the reader's buffer
        for this thread, valid until its next call: ``collate`` copies
        them."""
        from transformer_tts_tpu_torch.data import native
        paths = [self.rows[i][0] for i in indices]
        if (self.is_ar or self.hp.output_type
                or not all(p.endswith(".npy") or ".htk" in p
                           for p in paths)):
            return [self[i] for i in indices]
        mean, var = self.normalizer.arrays()
        max_len = max(max(self.hp.length_buckets), 4096)
        buf, lengths = native.load_mel_batch(
            paths, max_len, self.hp.mel_dim, mean, var,
            n_threads=n_threads)
        return [self[i] if n < 0 or n >= max_len
                else self.__getitem__(i, _preloaded_mel=buf[row, :n])
                for row, (i, n) in enumerate(zip(indices, lengths))]

    def mel_lengths(self, cache_file: Optional[str] = None) -> np.ndarray:
        """Per-utterance mel lengths, from the .npy headers alone (cached
        in ``cache_file`` when given)."""
        if cache_file and os.path.exists(cache_file):
            lengths = np.load(cache_file)
            if len(lengths) != len(self):
                raise ValueError(
                    f"lengths file {cache_file} has {len(lengths)} entries "
                    f"for a {len(self)}-utterance script")
            return lengths
        lengths = np.array([np.load(row[0], mmap_mode="r").shape[0]
                            for row in self.rows])
        if self.is_ar and not self.hp.output_type:
            # the go frame, rounded up to r
            lengths = round_up(lengths + 1, self.hp.reduction_rate)
        if cache_file:
            np.save(cache_file, lengths)
        return lengths
