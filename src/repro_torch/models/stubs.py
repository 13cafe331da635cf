"""Modality-frontend stubs: token streams for the audio and vision
decoders.

Counterpart of ``repro/models/stubs.py``, drawn with
:mod:`repro_torch.random` on the key's device, so every stream is the
reference's bit for bit.

* ``audio_tokens``   — EnCodec-style codebook ids (musicgen-large).
* ``vq_image_tokens``— interleaved text + VQ-image spans within the fused
  vocabulary (chameleon-34b): image spans are 1024-token blocks drawn from
  the top 8192 ids (Chameleon reserves a contiguous VQ range).
"""
from __future__ import annotations

import torch

from repro_torch import random as rnd
from repro_torch.models.config import ModelConfig


def audio_tokens(key: torch.Tensor, cfg: ModelConfig, batch: int,
                 seq: int) -> torch.Tensor:
    """EnCodec frame tokens (flattened codebook stream)."""
    return rnd.randint(key, (batch, seq), 0, cfg.vocab)


def vq_image_tokens(key: torch.Tensor, cfg: ModelConfig, batch: int,
                    seq: int, image_span: int = 1024) -> torch.Tensor:
    """Early-fusion stream: text tokens with VQ image-token spans."""
    k_txt, k_img, k_pos = rnd.split(key, 3)
    # reserved VQ range: top 8192 ids, or the top half for reduced vocabs
    vq_lo = max(cfg.vocab - 8192, cfg.vocab // 2)
    image_span = min(image_span, max(seq // 2, 1))
    text = rnd.randint(k_txt, (batch, seq), 0, vq_lo)
    img = rnd.randint(k_img, (batch, seq), vq_lo, cfg.vocab)
    start = rnd.randint(k_pos, (batch, 1), 0, max(seq - image_span, 1))
    pos = torch.arange(seq, device=key.device)[None, :]
    in_span = (pos >= start) & (pos < start + image_span)
    return torch.where(in_span, img, text)


def tokens_for(cfg: ModelConfig, key: torch.Tensor, batch: int,
               seq: int) -> torch.Tensor:
    if cfg.modality == "audio":
        return audio_tokens(key, cfg, batch, seq)
    if cfg.modality == "vlm":
        return vq_image_tokens(key, cfg, batch, seq)
    return rnd.randint(key, (batch, seq), 0, cfg.vocab)
