"""The Q-net work each cell's iteration needs, against counts made by hand."""

import json

import pytest
from conftest import ROOT

from benchmark.harness import algorithm, load_cell

# Envelope: layers 10x256, 3 x 256x256, 256x18 -> sum of in*out 203,776; the
# first layer's input gradient (10x256) is not needed.  GPI-LS, per critic:
# embeddings 7x256 and 3x256, head 3 x 256x256 + 256x18 = 201,216.
ENV_IO, ENV_IO_BWD_X = 203_776, 203_776 - 10 * 256
GPI_HEAD = 3 * 256 * 256 + 256 * 18


def envelope(n, b, w, u):
    rows = b * w
    update = 3 * 2 * rows * ENV_IO + 2 * rows * ENV_IO + 2 * rows * ENV_IO_BWD_X
    return 2 * n * ENV_IO + u * update


def gpils(n, m, b, u, c=2):
    act = 2 * n * 7 * 256 + 2 * m * 3 * 256 + 2 * n * m * GPI_HEAD
    fwd = 2 * b * (7 * 256 + 3 * 256 + GPI_HEAD)
    bwd = fwd + 2 * b * GPI_HEAD  # every kernel's gradient, the head's input gradients
    return c * (act + u * (2 * fwd + bwd))


HAND = {
    "envelope-minecart.wide": envelope(32768, 128, 4, 16),
    "gpils-minecart.proto": gpils(64, 16, 512, 8),
    "envelope-minecart.proto": envelope(64, 512, 4, 8),
    "gpils-minecart.wide": gpils(4096, 16, 128, 10),
}


# (configuration, traffic) of each count, read from their files: gpils-minecart.wide
# is out of BENCHMARK.json (PERF.md §7) and its files stay for a later PR
FILES = {
    "envelope-minecart.wide": ("envelope-minecart", "wide-32768"),
    "gpils-minecart.proto": ("gpils-minecart", "proto"),
    "envelope-minecart.proto": ("envelope-minecart", "proto"),
    "gpils-minecart.wide": ("gpils-minecart", "wide-4096"),
    "envelope-pixel.wide": ("envelope-pixel", "pixel-2048"),
}


@pytest.mark.parametrize("cell", sorted(HAND))
def test_flops_of_an_iteration(cell):
    conf, traffic = FILES[cell]
    config = json.loads((ROOT / "benchmark" / "configs" / f"{conf}.json").read_text())
    gemms = algorithm(config["algorithm"]).gemms(config, json.loads((ROOT / "benchmark" / "traffic" / f"{traffic}.json").read_text()))
    assert sum(2 * m * k * n for m, k, n in gemms) == HAND[cell]


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_every_cell_is_counted(cell):
    c = load_cell(ROOT, cell)
    assert (c.config, c.traffic) == tuple(
        json.loads((ROOT / "benchmark" / sub / f"{name}.json").read_text()) for sub, name in zip(("configs", "traffic"), FILES[cell]))


def test_hand_counts_in_numbers():
    """The four counts written out, so a change to the helpers above shows."""
    assert HAND == {
        "envelope-minecart.wide": 30_006_050_816,
        "gpils-minecart.proto": 14_137_409_536,
        "envelope-minecart.proto": 33_328_857_088,
        "gpils-minecart.wide": 56_937_201_664,
    }
