"""What the two streaming drivers share: the recording as an endless
stream of fixed-size pieces, the chain built from the configuration, and
the check of its packets."""

from __future__ import annotations

import math

import numpy as np

from phybench import check


class Looped:
    """The traffic's recording, replayed end to end without a break: piece
    i holds stream samples [i * piece, (i + 1) * piece), a view of a copy
    of the recording tiled until pieces and repeats line up."""

    def __init__(self, traffic, piece: int):
        re, im = traffic.stream
        self.t, self.n, self.piece = traffic, re.size, piece
        loops = piece // math.gcd(self.n, piece)
        self.re, self.im = np.tile(re, loops), np.tile(im, loops)
        self.count = loops * self.n // piece

    def __getitem__(self, i: int):
        k = (i % self.count) * self.piece
        return self.re[k:k + self.piece], self.im[k:k + self.piece]

    def frames(self, upto: int, whole: bool = True):
        """(start, frame index in the recording) of every frame that lies
        whole in stream samples [0, upto), or with whole=False of every
        frame that starts there and does not."""
        fl = self.t.frame_len
        for r in range(upto // self.n + 1):
            for j, s in enumerate(self.t.stream_starts):
                start = r * self.n + int(s)
                if start < upto and (start + fl <= upto) == whole:
                    yield start, j

    def answer(self, j: int) -> tuple:
        """(payload bytes, rate name, length) of recording frame j."""
        t = self.t
        return t.payloads[j].tobytes(), t.rate_name, t.length

    def planted(self, upto: int, whole: bool = True) -> dict:
        """{(0, start): answer} of the noiseless frames of frames()."""
        return {(0, start): self.answer(j)
                for start, j in self.frames(upto, whole)
                if not self.t.noisy[j]}

    def region(self, start: int):
        """check.region of the frame at stream position `start`: the
        recording is cyclic, and before the stream's start lie zeros."""
        local = start % self.n
        idx = np.arange(local - check.GUARD,
                        local + self.t.frame_len + check.GUARD)
        re, im = (np.take(x, idx, mode="wrap") for x in self.t.stream)
        if start < check.GUARD:
            re[:check.GUARD - start] = 0
            im[:check.GUARD - start] = 0
        return (re, im), check.GUARD


def make_chain(ctx, **overrides):
    from fun_ofdm_tpu_torch.config import ChainParams
    from fun_ofdm_tpu_torch.rates import Rate
    from fun_ofdm_tpu_torch.runtime.chain import ReceiverChain

    cfg, tr = ctx.config, ctx.traffic
    params = ChainParams(chunk_size=int(cfg["read_samples"]),
                         strides_per_step=tr.get("strides_per_step"))
    return ReceiverChain(rates=(Rate[cfg["rate"]],),
                         max_length=int(cfg["max_length"]),
                         params=params, ingest_dtype=cfg["ingest_dtype"],
                         device=ctx.device, **overrides)


def packet_rows(pkts) -> list:
    return [(p.channel, p.start, p.payload, p.rate.name, p.length)
            for p in pkts]


def outcome(looped: Looped, pkts: list, fed: int, rng, device):
    """(attempted, failed, numbers) of a stream: every frame fed whole is
    due. The noiseless ones are compared with what was planted, a sample of
    them through the plain receiver too; the noisy ones with the plain
    receiver's float64 answer, one decode for each distinct frame of the
    recording."""
    t = looped.t
    noisy_at = {s: j for whole in (True, False)
                for s, j in looped.frames(fed, whole) if t.noisy[j]}
    rows, got_noisy, repeats = [], {}, 0
    for row in packet_rows(pkts):
        if row[0] == 0 and row[1] in noisy_at:
            repeats += row[1] in got_noisy
            got_noisy[row[1]] = row[2:]
        else:
            rows.append(row)
    planted = looped.planted(fed)
    numbers = {"frames_wrong": repeats + check.compare_frames(
        rows, planted, looped.planted(fed, whole=False))}
    program: dict = {}
    for s, j in looped.frames(fed):
        if t.noisy[j]:
            program.setdefault(j, []).append(got_noisy.get(s))
    distinct = sorted(program)
    ref = dict(zip(distinct, check.answers(
        [looped.region(int(t.stream_starts[j])) for j in distinct], device)))
    numbers["noisy_vs_ref"] = check.noisy_vs_ref(program, ref)
    got = {(r[0], r[1]): r[2] for r in rows}
    keys = sorted(planted)
    pick = sorted(rng.choice(len(keys), size=min(32, len(keys)),
                             replace=False)) if keys else []
    regions = [looped.region(keys[i][1]) for i in pick]
    expected = [(planted[keys[i]][0], t.rate, t.length) for i in pick]
    sampled = [got.get(keys[i]) for i in pick]
    numbers.update(check.reference_sample(regions, expected, sampled,
                                          device) if pick else {})
    failed = sum(1 for k, v in planted.items() if got.get(k) != v[0])
    failed += sum(1 for j, answers in program.items()
                  for a in answers if a != ref[j])
    return sum(len(v) for v in program.values()) + len(planted), failed, \
        numbers
