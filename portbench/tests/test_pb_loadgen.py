"""The load generator's window against an in-process fake S3 endpoint
(no cluster): the single-PUT mix sends the same request stream as
before multipart mixes existed, and a multipart mix follows
s3transfer's model, records every request and checks every ETag."""

import hashlib
import threading
import time

import pytest

from portbench import check, loadgen, reference, traffic


class FakeS3:
    """Answers a client's requests as S3 would, from memory, after
    `delay` seconds; `bad_part` returns a wrong ETag for that part
    number, `bad_complete` a wrong upload ETag."""

    def __init__(self, delay=0.002, bad_part=None, bad_complete=False):
        self.delay, self.bad_part = delay, bad_part
        self.bad_complete = bad_complete
        self.lock = threading.Lock()
        self.log = []  # (method, path, query, length, md5 hex, start, end)
        self.parts = {}  # upload id -> {n: body}
        self.objects = {}
        self.in_flight = self.most_in_flight = 0

    def _rec(self, method, path, query, body):
        with self.lock:
            self.in_flight += 1
            self.most_in_flight = max(self.most_in_flight, self.in_flight)
        t0 = time.perf_counter()
        time.sleep(self.delay)
        with self.lock:
            self.in_flight -= 1
            self.log.append((method, path, dict(query), len(body),
                             hashlib.md5(body).hexdigest(), t0,
                             time.perf_counter()))

    def client(self, *a, **kw):
        return FakeClient(self)


class FakeClient:
    def __init__(self, s3):
        self.s3 = s3

    def close(self):
        pass

    def put_unsigned(self, path, body, query=()):
        s3, q = self.s3, dict(query)
        s3._rec("PUT", path, query, body)
        etag = hashlib.md5(body).hexdigest()
        if "uploadId" in q:
            n = int(q["partNumber"])
            with s3.lock:
                s3.parts[q["uploadId"]][n] = body
            if n == s3.bad_part:
                etag = hashlib.md5(body + b"x").hexdigest()
        else:
            s3.objects[path] = body
        return 200, {"etag": f'"{etag}"'}, b""

    def create_multipart(self, path):
        s3 = self.s3
        s3._rec("POST", path, [("uploads", "")], b"")
        uid = hashlib.sha256(path.encode()).hexdigest()
        with s3.lock:
            s3.parts[uid] = {}
        return 200, {}, uid

    def complete_multipart(self, path, upload_id, etags):
        s3 = self.s3
        s3._rec("POST", path, [("uploadId", upload_id)], b"")
        parts = s3.parts[upload_id]
        assert sorted(parts) == list(range(1, len(etags) + 1))
        body = b"".join(parts[n] for n in sorted(parts))
        s3.objects[path] = body
        md5s = [bytes.fromhex(e) for e in etags]
        etag = reference.multipart_etag(md5s)
        if s3.bad_complete:
            etag = reference.multipart_etag(md5s[:-1])
        s3.etags = getattr(s3, "etags", {})
        s3.etags[path] = etag
        return 200, {}, etag

    def get(self, path):
        s3 = self.s3
        s3._rec("GET", path, [], b"")
        return 200, {"etag": f'"{s3.etags[path]}"'}, s3.objects[path]


def gen_for(spec, s3, monkeypatch, seed=2**31 + 77):
    monkeypatch.setattr(loadgen.sigv4, "Client", s3.client)
    g = loadgen.LoadGen({"traffic": spec, "seed": seed, "key_id": "k",
                         "secret": "s", "region": "garage", "bucket": "b",
                         "host": "h", "port": 1})
    out = []
    monkeypatch.setattr(loadgen, "emit", out.append)
    return g, out


# The stream of put_unsigned at seed 2**31 + 77, as the load generator
# sent it before multipart mixes existed: the sizes of objects 0-39 in
# order, and the SHA-256 of "<path>:<size>:<MD5 of the body>\n" over them.
PUT_UNSIGNED_SIZES = [
    1986607, 111418, 590622, 322039, 82273, 129660, 95743, 204342, 1466937,
    1083205, 799853, 7776152, 2311864, 436123, 175593, 2690373, 507527,
    70698, 6682122, 4239977, 3130854, 1260553, 4934167, 276731, 1707110,
    930809, 237798, 687321, 5742012, 3643453, 150889, 374765, 276731, 111418,
    4934167, 4239977, 1986607, 590622, 3130854, 2690373]
PUT_UNSIGNED_DIGEST = ("d3d67c5636237626fe8c8e865bf99ccbf1371ae73e307d0825"
                       "d99a4396ed5014")
# check.sample over put_unsigned's objects 0-149 at that seed, 64 MiB
PUT_UNSIGNED_SAMPLE = [
    11, 101, 106, 88, 134, 52, 135, 22, 83, 124, 3, 23, 105, 35, 112, 39,
    138, 40, 19, 136, 71, 92, 5, 7, 90, 129, 61, 33, 125, 50, 76, 4, 31, 142,
    93, 85, 110, 32, 75]


def test_put_unsigned_sends_the_stream_it_always_sent(monkeypatch):
    s3 = FakeS3()
    spec = traffic.load("put_unsigned")
    g, out = gen_for(spec, s3, monkeypatch)
    g.window(0.5, 0.0)
    done = out[-1]
    assert [e["event"] for e in out] == ["window_start", "window_end",
                                        "window_done"]
    by_path = {}
    for method, path, query, n, md5, *_ in s3.log:
        assert (method, query) == ("PUT", {})
        assert path not in by_path  # each PUT a fresh key
        by_path[path] = (n, md5)
    keys = [f"/b/p{i:07d}" for i in range(40)]
    assert [by_path[k][0] for k in keys] == PUT_UNSIGNED_SIZES
    lines = "".join(f"{k}:{by_path[k][0]}:{by_path[k][1]}\n" for k in keys)
    assert hashlib.sha256(lines.encode()).hexdigest() == PUT_UNSIGNED_DIGEST
    # one record a request, as before: the object's own bytes, its MD5
    # checked
    recs = done["records"]
    assert len(recs) == len(s3.log) and done["uploads"] == []
    for i, t0, t1, size, st, ok in recs:
        assert by_path[f"/b/p{i:07d}"][0] == size
        assert st == 200 and ok is True and t0 <= t1
    plan = traffic.Plan(spec, 2**31 + 77)
    units = [("put", i, plan.put_size(i)) for i in range(150)]
    picked = check.sample(units, 2**31 + 77, 64 << 20)
    assert [u[1] for u in picked] == PUT_UNSIGNED_SAMPLE


def multipart_spec(clients=4, part=4096):
    spec = dict(traffic.load("put_multipart_16m"))
    spec.update(clients=clients, size_min=4 * part // 3, size_max=10 * part,
                strata=8, multipart={"threshold": 2 * part,
                                     "part_size": part})
    return spec


def test_multipart_follows_the_cli_and_checks_every_etag(monkeypatch):
    s3 = FakeS3(delay=0.01)
    spec = multipart_spec()
    g, out = gen_for(spec, s3, monkeypatch)
    g.window(0.3, 0.1)
    done = out[-1]
    plan = traffic.Plan(spec, 2**31 + 77)
    creates = [e for e in s3.log if "uploads" in e[2]]
    completes = [e for e in s3.log if e[0] == "POST" and "uploadId" in e[2]]
    singles = [e for e in s3.log if e[0] == "PUT" and not e[2]]
    assert creates and len(completes) == len(creates)
    # objects under the threshold are one PutObject, as in a plain mix
    for _m, path, _q, n, *_ in singles:
        assert n == plan.put_size(int(path[4:])) < 2 * 4096
    # the clients' share of one FIFO: up to `clients` requests at once
    assert s3.most_in_flight == 4
    # an object opens when the FIFO holds no task, in order; its Create,
    # parts and Complete enter it at once, so the idle clients take its
    # parts and do not open others: one Create before the first part
    opened = sorted(int(e[1][4:]) for e in creates + singles)
    assert opened == list(range(len(opened)))
    first_part = min(e[5] for e in s3.log if "partNumber" in e[2])
    assert sum(1 for e in creates if e[5] < first_part) == 1
    # no object is opened after the close, and objects open until it;
    # every upload created before it runs to its Complete
    t_first = min(e[5] for e in s3.log)
    close = t_first + 0.4
    assert all(e[5] < close for e in creates + singles)
    assert max(e[5] for e in creates + singles) > t_first + 0.2
    ups = {u[0]: u for u in done["uploads"]}
    assert len(ups) == len(creates)
    for i, size, n, status, ok, c0, c1 in done["uploads"]:
        sizes = plan.part_sizes(size)
        assert n == len(sizes) and status == 200 and ok is True
        assert size == plan.put_size(i) and sum(sizes) == size
        assert all(s == 4096 for s in sizes[:-1])
        path = f"/b/p{i:07d}"
        # a part's body is drawn from (seed, object, part)
        assert s3.objects[path] == b"".join(
            plan.part_body(i, k, s) for k, s in enumerate(sizes, 1))
        start, = (e[5] for e in creates if e[1] == path)
        first_part = min(e[5] for e in s3.log if e[1] == path
                         and "partNumber" in e[2])
        end, = (e[5] for e in completes if e[1] == path)
        last_part = max(e[6] for e in s3.log if e[1] == path
                        and "partNumber" in e[2])
        assert start < first_part and last_part <= end
        # the upload's entry holds its Complete's start and end
        rec, = (r for r in done["records"] if r[0] == i and r[3] == 0
                and r[5] is not None)
        assert (c0, c1) == (rec[1], rec[2]) and c0 <= c1
    # records: a part carries its bytes, Create and Complete none; every
    # acknowledged ETag was checked
    recs = done["records"]
    assert len(recs) == len(s3.log)
    for i, _t0, _t1, size, st, ok in recs:
        assert st == 200
        if i not in ups:
            assert size == plan.put_size(i) and ok is True
        elif size:
            assert size in plan.part_sizes(ups[i][1]) and ok is True
    zero = sorted((r for r in recs if r[3] == 0), key=lambda r: r[1])
    first = {}
    for r in zero:
        first.setdefault(r[0], r)
    # Create (first, unchecked) and Complete (checked) of each upload
    assert sorted(r[0] for r in zero) == sorted(2 * list(ups))
    assert all((r[5] is None) == (first[r[0]] is r) for r in zero)
    assert all(r[5] in (None, True) for r in zero)
    assert sum(r[3] for r in recs if r[0] in ups) == sum(
        u[1] for u in done["uploads"])
    # the read-back is the smallest completed upload of two parts or more
    rb = g.readback()
    smallest = min((u for u in done["uploads"] if u[2] >= 2),
                   key=lambda u: (u[1], u[0]))
    assert (rb["index"], rb["ok"], rb["status"]) == (smallest[0], True, 200)


@pytest.mark.parametrize("fault", ["bad_part", "bad_complete"])
def test_a_wrong_etag_is_caught(monkeypatch, fault):
    s3 = FakeS3(**({"bad_part": 2} if fault == "bad_part"
                   else {"bad_complete": True}))
    spec = multipart_spec()
    g, out = gen_for(spec, s3, monkeypatch)
    g.window(0.2, 0.0)
    done = out[-1]
    bad = [r for r in done["records"] if r[4] == 200 and r[5] is False]
    wrong = [u for u in done["uploads"] if u[4] is False]
    if fault == "bad_part":
        # the part, and the upload whose ETag the server built from it
        assert any(r[3] > 0 for r in bad)  # the part's own record
        assert wrong == [u for u in done["uploads"] if u[2] >= 2]
    else:
        assert bad and all(r[3] == 0 for r in bad)
        assert len(wrong) == len(done["uploads"])
    assert g.readback()["ok"] is False


def test_a_short_read_back_is_caught(monkeypatch):
    s3 = FakeS3()
    g, out = gen_for(multipart_spec(), s3, monkeypatch)
    g.window(0.2, 0.0)
    rb = g.readback()
    assert rb["ok"] is True
    path = f"/b/p{rb['index']:07d}"
    s3.objects[path] = s3.objects[path][:-1]
    assert g.readback()["ok"] is False
