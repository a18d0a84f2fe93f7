"""CRNN-style OCR text-line recognizer (torch port of
`end2end_tpu/models/ocr.py`; BASELINE.json config 3: "OCR text-line
recognition, prefix beam search width 10").

    model = OCRRecognizer(vocab_size=96)           # on the card
    logits, out_widths = model(images, widths)     # (N, W/4, V), (N,)
    lp = torch.log_softmax(logits, -1).transpose(0, 1)
    loss = ctc_loss(lp, targets, out_widths, target_lengths)
    tokens, lengths, scores = beam_search_decode(lp, out_widths,
                                                 beam_width=10, prune_k=16)

Image columns are the CTC time axis: three 3x3 convolutions with ReLU
(32, 64 and d_model channels) and two 2x2 max-pools collapse an (N, H, W)
grey text line into (N, W/4, d_model) column features, the height
mean-pooled; sinusoidal positions, `num_layers` Conformer blocks (the
port's, depthwise kernel 7) over the valid columns and a Linear give the
logits over the characters and the blank (id 0).  Same math as the flax
model, so its weights (`load_jax_params`, utils/convert.py) give the same
logits:
  * images arrive (N, H, W) or (N, H, W, 1), as JAX takes them, and run
    as NCHW inside;
  * flax's stride-1 SAME 3x3 convolutions are padding 1 and its VALID
    pools `F.max_pool2d(2)`, which floors an odd height or width;
  * the padded columns are zeroed first, and the width masks follow
    `widths`, `widths // 2` and `widths // 4` after every ReLU, so the
    padding's content never reaches a valid column (bucket invariance).
Parameters are drawn as the encoder's (`models.conformer.init_like_flax`);
the model is built on the card unless `device` says otherwise
(utils/device.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.convert import ocr_state_dict_from_flax
from ..utils.device import resolve_device
from .conformer import (ConformerBlock, EveryRow, _length_mask,
                        init_like_flax, sinusoidal_positions)


def _mask_width(x, widths):
    """Zero the columns of NCHW x at and past each sample's width."""
    return x * _length_mask(widths, x.shape[3])[:, None, None, :]


class CRNNFeatures(nn.Module):
    """(N, 1, H, W) grey text lines -> (N, W/4, d_model) column features."""

    def __init__(self, d_model: int = 128):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv1 = nn.Conv2d(32, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, d_model, 3, padding=1)

    def forward(self, images, widths):
        x = _mask_width(F.relu(self.conv0(images)), widths)
        x = F.max_pool2d(x, 2)  # H/2, W/2
        w1 = widths // 2
        x = _mask_width(F.relu(self.conv1(x)), w1)
        x = F.max_pool2d(x, 2)  # H/4, W/4
        x = _mask_width(F.relu(self.conv2(x)), w1 // 2)
        return x.mean(dim=2).transpose(1, 2)  # height pooled

    @staticmethod
    def out_width(widths):
        return torch.as_tensor(widths) // 4  # two VALID (2, 2) max-pools


class OCRRecognizer(nn.Module):
    """Images + column widths -> CTC logits (N, W', vocab) and widths."""

    def __init__(self, vocab_size: int, d_model: int = 128,
                 num_layers: int = 2, num_heads: int = 4, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.d_model = d_model
        with torch.device("meta"):  # allocate once, on `device`, below
            self.features = CRNNFeatures(d_model)
            self.blocks = nn.ModuleList(
                ConformerBlock(d_model, num_heads, conv_kernel=7)
                for _ in range(num_layers))
            self.out = nn.Linear(d_model, vocab_size)
        self.to_empty(device=resolve_device(device))
        init_like_flax(self, generator)

    @property
    def device(self) -> torch.device:
        return self.out.weight.device

    def load_jax_params(self, params) -> None:
        """Load the flax `OCRRecognizer`'s parameters (nested dicts of numpy
        arrays)."""
        self.load_state_dict(ocr_state_dict_from_flax(params))

    def forward(self, images, widths):
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        if images.ndim == 4:
            images = images[..., 0]
        widths = torch.as_tensor(widths, device=self.device)
        x = _mask_width(images[:, None], widths)
        x = self.features(x, widths)
        out_w = CRNNFeatures.out_width(widths)
        rows = EveryRow(out_w, x.shape[1])
        pe = torch.from_numpy(sinusoidal_positions(x.shape[1], self.d_model))
        x = rows.gather(x + pe.to(x.device))
        for block in self.blocks:
            x = block(x, rows)
        return rows.scatter(self.out(x)), out_w
