"""The traffic generator: the same seed gives the same inputs, another
seed the same sizes and arrivals with other bytes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from phybench import generator

LAYOUTS = {
    "capture": ("sim1-r36-1500.json", "closed-captures.json"),
    "back_to_back": ("link1-r36-1500.json", "closed-recording.json"),
    "lone": ("link1-r36-1500.json", "open-lone-frames.json"),
}


def make(root, layout, seed):
    conf, traffic = LAYOUTS[layout]
    c = json.loads((root / "phybench" / "configs" / conf).read_text())
    t = json.loads((root / "phybench" / "traffic" / traffic).read_text())
    return generator.make(c, t, seed, "cpu")


def arrays(t):
    out = [t.payloads, t.noisy]
    for re, im in t.captures:
        out += [re.numpy(), im.numpy()]
    if t.stream is not None:
        out += list(t.stream) + [t.stream_starts]
    if t.capture_starts is not None:
        out.append(t.capture_starts)
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_same_seed_same_inputs(small_root, layout):
    a, b = make(small_root, layout, 2**31 + 5), make(small_root, layout,
                                                     2**31 + 5)
    for x, y in zip(arrays(a), arrays(b), strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_other_seed_same_sizes_other_bytes(small_root, layout):
    a, b = make(small_root, layout, 11), make(small_root, layout, 12)
    for x, y in zip(arrays(a), arrays(b), strict=True):
        assert x.shape == y.shape
    assert not np.array_equal(a.payloads, b.payloads)
    if a.stream is not None:
        np.testing.assert_array_equal(a.stream_starts, b.stream_starts)
    # every frame of a cell carries its own bytes
    assert len({p.tobytes() for p in a.payloads}) == len(a.payloads)


def test_frames_sit_where_planted(small_root):
    t = make(small_root, "back_to_back", 3)
    re, _ = t.stream
    for s in t.stream_starts:
        assert np.abs(re[s:s + t.frame_len]).max() > 0
    assert t.stream_starts[1] - t.stream_starts[0] == t.frame_len


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_second_frame_is_noisy_after_its_preamble(small_root, layout):
    from phybench.reference import phy

    t = make(small_root, layout, 2**31 + 8)
    assert t.noisy.tolist() == [i % 2 == 1 for i in range(t.noisy.size)]
    clean = phy.build_frames(t.payloads, t.rate).to(torch.complex64)
    if t.stream is not None:
        re, im = t.stream
        got = np.stack([re[s:s + t.frame_len] + 1j * im[s:s + t.frame_len]
                        for s in t.stream_starts])
    else:
        got = np.concatenate([(re.numpy() + 1j * im.numpy())[
            :, :t.capture_starts.shape[2] * t.frame_len].reshape(
                -1, t.frame_len) for re, im in t.captures])
    err = np.abs(got - clean.numpy())
    pre = phy.PREAMBLE_LEN
    # the preambles are clean (to the wire's grid), the noisy bodies not
    assert err[:, :pre].max() < 0.01
    assert (err[t.noisy, pre:].mean(1) > 0.01).all()
    assert err[~t.noisy, pre:].max() < 0.01


def test_stream_samples_lie_on_the_wire_grid(small_root):
    t = make(small_root, "back_to_back", 4)
    for x in t.stream:
        np.testing.assert_array_equal(x * 128, np.round(x * 128))
