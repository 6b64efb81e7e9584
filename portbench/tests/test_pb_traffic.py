"""The traffic generator: sizes and bodies repeat from a seed, and
every seed sends the same multiset of sizes."""

import collections

from portbench import traffic


def test_sizes_and_bodies_repeat_from_a_seed():
    spec = traffic.load("put_signed")
    a, b = traffic.Plan(spec, 2**31 + 5), traffic.Plan(spec, 2**31 + 5)
    assert [a.put_size(i) for i in range(200)] == \
        [b.put_size(i) for i in range(200)]
    assert a.body("put", 17, 70000) == b.body("put", 17, 70000)
    assert a.body("put", 17, 70000) != a.body("put", 18, 70000)
    other = traffic.Plan(spec, 2**31 + 6)
    assert a.body("put", 17, 70000) != other.body("put", 17, 70000)


def test_every_seed_sends_the_same_sizes_in_another_order():
    spec = traffic.load("put_signed")
    sizes = traffic.size_set(spec)
    n = len(sizes)
    orders = []
    for seed in (1, 2, 3**20):
        plan = traffic.Plan(spec, seed)
        got = [plan.put_size(i) for i in range(4 * n)]
        for g in range(4):
            assert sorted(got[g * n:(g + 1) * n]) == sorted(sizes)
        orders.append(got)
    assert orders[0] != orders[1]


def test_size_law_spans_one_chunk_to_the_multipart_threshold():
    d = traffic.describe(traffic.load("put_unsigned"))
    assert 65536 < d["min"] < 80000 and 7 << 20 < d["max"] < 8 << 20
    assert 1.6e6 < d["mean"] < 1.8e6


def test_fill_and_get_targets_cover_every_object():
    spec = traffic.load("get_degraded")
    plan = traffic.Plan(spec, 99)
    n = plan.fill_count
    assert n == 128
    fill = collections.Counter(plan.fill_size(j) for j in range(n))
    assert set(fill.values()) == {4}
    targets = [plan.get_target(i) for i in range(2 * n)]
    assert sorted(targets[:n]) == list(range(n))
    assert sorted(targets[n:]) == list(range(n))


def test_blocks_and_chunks_of_a_body():
    assert traffic.blocks_of(2_500_000, 1 << 20) == [1 << 20, 1 << 20,
                                                      2_500_000 - (2 << 20)]
    assert traffic.blocks_of(1 << 20, 1 << 20) == [1 << 20]
    assert traffic.chunks_of(65536 * 2 + 5, 65536) == [65536, 65536, 5]


def test_the_multipart_mix():
    """put_multipart_16m: the AWS CLI's 8 MiB threshold and 16 MiB parts
    over objects from that threshold to 100 MB, log-uniform in 32
    strata: 1 to 6 parts, every part but the last a whole part; each
    group of 32 objects holds every size once, in a seeded order."""
    spec = traffic.load("put_multipart_16m")
    assert spec["multipart"] == {"threshold": 8 << 20, "part_size": 16 << 20}
    assert (spec["op"], spec["payload"], spec["clients"], spec["strata"]) \
        == ("put", "unsigned", 10, 32)
    d = traffic.describe(spec)
    assert 8 << 20 < d["min"] < d["max"] < 100e6
    assert 36.9e6 < d["mean"] < 37.0e6
    counts = []
    for size in traffic.size_set(spec):
        parts = traffic.Plan(spec, 1).part_sizes(size)
        assert sum(parts) == size and set(parts[:-1]) <= {16 << 20}
        assert 0 < parts[-1] <= 16 << 20
        counts.append(len(parts))
    assert counts == [1] * 9 + [2] * 9 + [3] * 5 + [4] * 4 + [5] * 3 + [6] * 2
    groups = []
    for seed in (2**31 + 9, 2**31 + 10, 3**30):
        plan = traffic.Plan(spec, seed)
        group = [plan.put_size(i) for i in range(32, 64)]
        assert sorted(group) == plan.sizes
        groups.append(group)
    assert groups[0] != groups[1]


def test_parts_and_bodies():
    spec = {"size_min": 1, "size_max": 2, "strata": 1,
            "multipart": {"threshold": 100, "part_size": 40}}
    plan = traffic.Plan(spec, 5)
    assert plan.part_sizes(99) is None
    assert plan.part_sizes(100) == [40, 40, 20]
    assert plan.part_sizes(120) == [40, 40, 40]
    assert traffic.Plan(traffic.load("put_unsigned"), 5).part_sizes(
        8 << 20) is None
    a = plan.part_body(3, 1, 40)
    assert a == traffic.Plan(spec, 5).part_body(3, 1, 40)
    assert a != plan.part_body(3, 2, 40) != plan.part_body(4, 1, 40)
    assert a != traffic.Plan(spec, 6).part_body(3, 1, 40)
    assert a != plan.body("put", 3, 40)
