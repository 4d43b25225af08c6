"""Plain reference of a quantized fixed-point network, in PyTorch.

It computes what a bit-exact integer design of the network must give,
from the network's definition alone: the layer list of a configuration
file (``dabench/configs/<name>.json``) and the float weights stored
beside it (``<name>.params.npz``).  It imports nothing of the program
under test and never reads a compiled design: it quantizes the weights
itself.

Semantics (the paper's fixed-point arithmetic, as the configuration
states it):

* every value lives on a power-of-two grid ``2**e``; the inputs on the
  input grid ``fixed<signed, bits, int_bits>`` (step
  ``2**(int_bits - bits)``), given as grid integers;
* a weight is rounded half to even onto its grid and saturated; a
  product-sum is exact, on the grid ``e_in + e_w``; a bias is rounded
  half up onto that grid;
* a convolution is VALID, or SAME where its entry says ``"padding":
  "same"``: per spatial axis of size ``n``, kernel ``k`` and stride ``s``,
  ``max((ceil(n / s) - 1) * s + k - n, 0)`` zeros, ``total // 2`` before
  and the rest after, so ``ceil(n / s)`` outputs; zero lies on every
  grid, so padding rounds nothing;
* ``relu`` clips at 0; with an ``out_quant`` it then floors onto the
  activation grid and saturates;
* max pooling keeps the grid; average pooling over ``k`` cells (a power
  of two) is the exact sum on the grid ``e - log2(k)``;
* a residual adds both branches exactly, on the finer of their grids.

Values are carried as reals of ``dtype``.  In float64 they are exact:
every value has few significant bits and every sum stays far below
2**53 units of its grid (below 2**24 in both configurations, so float32
would be exact too).  A convolution is one matrix product per kernel
offset, summed, so no convolution algorithm rounds anything.  In
bfloat16 (8 significant bits) sums round: that is the control, the
reference a precision below the one the design needs.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def padding(layer: dict) -> str:
    """A ``conv2d`` entry's padding: ``"valid"`` (also where the entry
    names none) or ``"same"``."""
    pad = layer.get("padding", "valid")
    if pad not in ("valid", "same"):
        raise ValueError(f"unknown padding {pad!r}")
    return pad


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """Zeros before and after an axis of ``n`` for a SAME window of ``k``
    at stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def grid(q: dict) -> tuple[int, int, int]:
    """(exponent, lo, hi) of the grid fixed<signed, bits, int_bits>."""
    e = q["int_bits"] - q["bits"]
    if q["signed"]:
        return e, -(1 << (q["bits"] - 1)), (1 << (q["bits"] - 1)) - 1
    return e, 0, (1 << q["bits"]) - 1


class Reference:
    """The network of one configuration on ``device``, in ``dtype``.

    ``config``: the configuration file's dict (``in_quant``, ``quant``,
    ``layers``); ``params``: a mapping of ``"/"``-joined layer paths
    (``"0/w"``, ``"4/body/2/b"``) to float arrays.
    """

    def __init__(self, config: dict, params, device="cpu", dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        self.quant = config["quant"]
        self.in_quant = config["in_quant"]
        self.layers = config["layers"]
        # weights and biases quantized once, in float64, then cast
        self._w: dict[str, tuple[torch.Tensor, int]] = {}
        self._b: dict[str, torch.Tensor] = {}
        self._prepare(self.layers, "", grid(self.in_quant)[0], params)

    def _prepare(self, layers, prefix: str, e: int, params) -> int:
        for i, layer in enumerate(layers):
            path = f"{prefix}{i}"
            kind = layer["kind"]
            if kind in ("dense", "dense_on_axis", "conv2d"):
                ew, lo, hi = grid(self.quant[layer["w_quant"]])
                w = np.clip(np.round(np.asarray(params[f"{path}/w"], np.float64) * 2.0 ** -ew), lo, hi)
                e_acc = e + ew
                b = np.floor(np.asarray(params[f"{path}/b"], np.float64) * 2.0 ** -e_acc + 0.5)
                self._w[path] = (self._put(w * 2.0 ** ew), e_acc)
                self._b[path] = self._put(b * 2.0 ** e_acc)
                e = e_acc
            elif kind == "relu" and layer.get("out_quant"):
                e = grid(self.quant[layer["out_quant"]])[0]
            elif kind == "avgpool":
                e -= self._avg_shift(layer)
            elif kind == "residual":
                e = min(e, self._prepare(layer["body"], f"{path}/body/", e, params))
        return e

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float64, device=self.device).to(self.dtype)

    @staticmethod
    def _avg_shift(layer: dict) -> int:
        k = layer["size"][0] * layer["size"][1]
        if k & (k - 1):
            raise ValueError("average pooling needs a power-of-two window")
        return int(math.log2(k))

    # ------------------------------------------------------------------
    def forward(self, x_int: torch.Tensor, block: int = 16384) -> torch.Tensor:
        """Integer outputs (int64, on the output grid, on the host) of the
        grid integers ``x_int`` [B, *in_shape], in blocks of ``block``
        samples."""
        outs = [self._forward_block(x_int[i:i + block]) for i in range(0, x_int.shape[0], block)]
        return torch.cat(outs) if outs else torch.zeros(0, dtype=torch.int64)

    def _forward_block(self, x_int: torch.Tensor) -> torch.Tensor:
        return self.on_device(x_int).cpu()

    def on_device(self, x_int: torch.Tensor) -> torch.Tensor:
        """Integer outputs (int64, on the output grid) of ``x_int`` in one
        block, left on the device: nothing waits for the host, so a CUDA
        graph can capture it."""
        e, lo, hi = grid(self.in_quant)
        x = x_int.to(self.device, torch.float64).clamp(lo, hi) * 2.0 ** e
        v, e = self._seq(self.layers, "", x.to(self.dtype), e)
        return torch.round(v.to(torch.float64) * 2.0 ** -e).to(torch.int64)

    def __call__(self, x_int: torch.Tensor) -> torch.Tensor:
        return self.forward(x_int)

    def _seq(self, layers, prefix: str, v, e: int):
        for i, layer in enumerate(layers):
            v, e = self._layer(layer, f"{prefix}{i}", v, e)
        return v, e

    def _layer(self, layer: dict, path: str, v, e: int):
        kind = layer["kind"]
        if kind in ("dense", "dense_on_axis", "conv2d"):
            w, e_acc = self._w[path]
            b = self._b[path]
            if kind == "dense":
                return v @ w + b, e_acc
            if kind == "dense_on_axis":
                ax = layer["axis"] + 1  # the batch axis comes first
                return torch.movedim(torch.movedim(v, ax, -1) @ w + b, -1, ax), e_acc
            return self._conv(v, w, layer) + b, e_acc
        if kind == "relu":
            v = v.clamp(min=0)
            if not layer.get("out_quant"):
                return v, e
            eq, lo, hi = grid(self.quant[layer["out_quant"]])
            return torch.floor(v * 2.0 ** -eq).clamp(lo, hi) * 2.0 ** eq, eq
        if kind in ("maxpool", "avgpool"):
            ph, pw = layer["size"]
            n, h, w, c = v.shape
            win = v[:, : h // ph * ph, : w // pw * pw].reshape(n, h // ph, ph, w // pw, pw, c)
            if kind == "maxpool":
                return win.amax(dim=(2, 4)), e
            s = self._avg_shift(layer)
            return win.sum(dim=(2, 4)) * 2.0 ** -s, e - s
        if kind == "flatten":
            return v.reshape(v.shape[0], -1), e
        if kind == "residual":
            u, eb = self._seq(layer["body"], f"{path}/body/", v, e)
            return v + u, min(e, eb)
        raise ValueError(f"unknown layer kind {kind!r}")

    @staticmethod
    def _conv(v: torch.Tensor, w: torch.Tensor, layer: dict) -> torch.Tensor:
        """NHWC convolution with an HWIO kernel, VALID or SAME (zeros added
        first): one matrix product per kernel offset, summed."""
        kh, kw = layer["kernel"]
        sh, sw = layer["strides"]
        if padding(layer) == "same":
            (top, bottom), (left, right) = same_pads(v.shape[1], kh, sh), same_pads(v.shape[2], kw, sw)
            v = torch.nn.functional.pad(v, (0, 0, left, right, top, bottom))
        oh = (v.shape[1] - kh) // sh + 1
        ow = (v.shape[2] - kw) // sw + 1
        out = None
        for dy in range(kh):
            for dx in range(kw):
                patch = v[:, dy: dy + sh * (oh - 1) + 1: sh, dx: dx + sw * (ow - 1) + 1: sw, :]
                term = patch @ w[dy, dx]
                out = term if out is None else out + term
        return out


def load(config: dict, root, device="cpu", dtype=torch.float64) -> Reference:
    """The reference of ``config``, its weights read from the file the
    configuration names (relative to the checkout's ``root``)."""
    with np.load(root / config["params"], allow_pickle=False) as z:
        params = {k: z[k] for k in z.files}
    return Reference(config, params, device=device, dtype=dtype)
