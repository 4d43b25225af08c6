"""The benchmark's yardstick: the card's peaks, the work a network must do
(multiply-accumulates and bytes of each matrix application, counted from
the configuration's layer list, not from any design), the least time the
card could take for it, and the percentile arithmetic.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math

from .reference import network

# Published dense peaks of one card by ``torch.cuda.get_device_name()``
# (NVIDIA's data sheet, SXM part, at its 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "int8_ops_per_s": 1.979e15,
    },
}


def matrix_calls(config: dict) -> list[dict]:
    """Each matrix application of one sample, in layer order: the rows it
    applies the matrix to and the matrix's shape (``n_in`` x ``n_out``).

    A dense layer applies its matrix to every vector along the last axis,
    a dense layer on an axis to every vector along that axis, a
    convolution at every output position: ``(n - k) // s + 1`` of them
    along an axis of ``n`` where it is VALID (also where its entry names
    no ``padding``), ``ceil(n / s)`` where it is SAME, on the axis padded
    as the plain reference pads it (``network.same_pads``)."""
    calls: list[dict] = []

    def walk(layers, shape):
        for layer in layers:
            kind = layer["kind"]
            if kind == "dense":
                calls.append({"rows": math.prod(shape[:-1]), "n_in": shape[-1], "n_out": layer["units"]})
                shape = shape[:-1] + [layer["units"]]
            elif kind == "dense_on_axis":
                ax = layer["axis"]
                calls.append({"rows": math.prod(shape) // shape[ax], "n_in": shape[ax],
                              "n_out": layer["units"]})
                shape = shape[:ax] + [layer["units"]] + shape[ax + 1:]
            elif kind == "conv2d":
                (h, w, c), (kh, kw), (sh, sw) = shape, layer["kernel"], layer["strides"]
                if network.padding(layer) == "same":
                    h, w = h + sum(network.same_pads(h, kh, sh)), w + sum(network.same_pads(w, kw, sw))
                oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
                calls.append({"rows": oh * ow, "n_in": kh * kw * c, "n_out": layer["filters"]})
                shape = [oh, ow, layer["filters"]]
            elif kind in ("maxpool", "avgpool"):
                (h, w, c), (ph, pw) = shape, layer["size"]
                shape = [h // ph, w // pw, c]
            elif kind == "flatten":
                shape = [math.prod(shape)]
            elif kind == "residual":
                if walk(layer["body"], shape) != shape:
                    raise ValueError("a residual body changes the shape")
            elif kind != "relu":
                raise ValueError(f"unknown layer kind {kind!r}")
        return shape

    walk(config["layers"], list(config["in_shape"]))
    return calls


def macs_per_sample(config: dict) -> int:
    """Multiply-accumulates of one sample, from the matrices' shapes (not
    from their adders, so a design with fewer adders is charged the same
    work)."""
    return sum(c["rows"] * c["n_in"] * c["n_out"] for c in matrix_calls(config))


def bound_s(config: dict, samples: int, peaks: dict) -> float:
    """The least time the matrix applications of ``samples`` samples can
    take on the card: for each application the larger of its int32
    inputs read once and outputs written once at the HBM rate, and of 2 x
    its multiply-accumulates at the int8 dense peak; summed."""
    total = 0.0
    for c in matrix_calls(config):
        rows = c["rows"] * samples
        total += max(4 * rows * (c["n_in"] + c["n_out"]) / peaks["hbm_bytes_per_s"],
                     2 * rows * c["n_in"] * c["n_out"] / peaks["int8_ops_per_s"])
    return total


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) of unsorted values."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))]

