"""The frozen corpus and the traffic generator."""

import json
import math

import pytest

from portbench import corpus, traffic


def test_frozen_text():
    t = corpus.text()
    assert len(t) == corpus.TEXT_BYTES


SMALL = {"archive": traffic.Mix(3 << 20, [[3 << 20, 1]], 2),
         "objects": traffic.Mix(3 << 20, [[4096, 6], [65536, 6], [1 << 20, 4]], 2)}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_same_seed_same_bytes_other_seed_other_bytes(name):
    small = SMALL[name]
    a = traffic.generate(small, 2 ** 31 + 11)
    b = traffic.generate(small, 2 ** 31 + 11)
    c = traffic.generate(small, 2 ** 31 + 12)
    assert a.objects == b.objects and list(a.order) == list(b.order)
    assert a.objects != c.objects
    assert [len(o) for o in a.objects] == [len(o) for o in c.objects] == small.sizes()
    assert sorted(a.order) == list(range(small.count))


def test_large_and_negative_seeds():
    mix = traffic.Mix(1 << 20, [[4096, 1], [8192, 1]], 2)
    for seed in (0, -5, 2 ** 33 + 1, 2 ** 64 + 3):
        assert [len(o) for o in traffic.generate(mix, seed).objects] == [4096, 8192]


def test_sizes_follow_the_histogram_in_order():
    mix = traffic.Mix(1 << 20, [[5000, 2], [300, 1], [70000, 3]], 1)
    assert mix.sizes() == [5000, 5000, 300, 70000, 70000, 70000] and mix.count == 6


def write_mix(tmp_path, monkeypatch, spec):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "probe.json").write_text(json.dumps(spec))
    monkeypatch.setattr(traffic, "HERE", str(tmp_path))
    return traffic.load("probe")


def test_a_key_the_generator_does_not_know_is_an_error(tmp_path, monkeypatch):
    spec = {"why": "probe", "operation": "decompress", "corpus_bytes": 1 << 20,
            "sizes": [[4096, 2]], "checked_blocks": 1}
    assert write_mix(tmp_path, monkeypatch, spec).sizes() == [4096, 4096]
    with pytest.raises(ValueError, match="clients"):
        (tmp_path / "traffic" / "probe.json").write_text(json.dumps(dict(spec, clients=8)))
        traffic.load("probe")
    (tmp_path / "traffic" / "probe.json").write_text(
        json.dumps(dict(spec, sizes=[[2 << 20, 1]])))
    with pytest.raises(ValueError, match="sizes"):
        traffic.load("probe")


def test_archive_is_silesia_sized():
    mix = traffic.load("archive")
    assert mix.sizes() == [211_957_760] and mix.operation == "decompress"
    assert math.ceil(211_957_760 / (4 << 20)) == 51


def ratios(pieces):
    """How well zlib packs each piece: close for pieces of the same kinds."""
    import zlib
    return [len(zlib.compress(p, 1)) / len(p) for p in pieces]


def strides(data):
    return [data[i:i + (1 << 20)] for i in range(0, len(data), 1 << 20)]


def test_every_seed_puts_the_same_kinds_of_data_in_the_same_places():
    mix = traffic.Mix(16 << 20, [[64 << 10, 4], [1 << 20, 4]], 2)
    a = traffic.generate(mix, 1)
    b = traffic.generate(mix, 2 ** 32 + 77)
    assert a.objects != b.objects
    for x, y in zip(ratios(a.objects), ratios(b.objects)):
        assert abs(x - y) < 0.02
    archive = traffic.Mix(16 << 20, [[16 << 20, 1]], 2)
    ra = ratios(strides(traffic.generate(archive, 5).objects[0]))
    rb = ratios(strides(traffic.generate(archive, 6).objects[0]))
    assert max(abs(x - y) for x, y in zip(ra, rb)) < 0.02
    assert max(ra) - min(ra) > 0.5          # the kinds do differ stride to stride


def test_every_window_of_whole_rounds_asks_for_the_same_objects():
    import numpy as np
    sizes = [64 << 10] * 128 + [1 << 20] * 128
    orders = [traffic.call_order(256, np.random.default_rng(s)) for s in (1, 2, 3)]
    assert orders[0].tolist() != orders[1].tolist()
    for o in orders:
        assert sorted(o.tolist()) == list(range(256))
    for k in range(16, 257, 16):
        assert len({frozenset(o[:k].tolist()) for o in orders}) == 1
    first = [sizes[i] for i in orders[0][:16].tolist()]
    assert min(first) == 64 << 10 and max(first) == 1 << 20
