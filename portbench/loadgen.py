"""The load generator: a process of its own, so that client signing and
sockets never share the nodes' interpreter lock, as a deployment's
clients sit on other hosts.

    python3 -m portbench.loadgen     (from the checkout root)

It reads one JSON object a line on standard input (the first the run's
parameters, then commands) and answers with one JSON object a line on
standard output. Commands:

- fill:     PUT the mix's fill objects, unsigned, with every client;
- warm:     each client sends one request of the window's kind (in a
            multipart mix, one upload of two small parts);
- window:   a closed loop of `clients` clients; each sends its next
            request when its reply is in. The loop runs `ramp` seconds,
            then the window opens for `seconds` seconds. At the close
            no object is opened; the requests in flight, and the tasks
            of the objects opened, run to their end. Prints
            window_start and window_end as they happen, then
            window_done with every request, the ramp's included, and
            every multipart upload;
- readback: GET one completed multipart upload whole (the smallest of
            two parts or more) and compare it with its parts;
- probe:    signed PUTs whose second chunk carries a forged signature;
- quit.

Multipart uploads follow s3transfer's model, the AWS CLI's: the clients
are worker threads that take tasks from one FIFO in order. Each object
opened puts its tasks there: an object of the mix's `threshold` or more
its CreateMultipartUpload, its UploadParts and its
CompleteMultipartUpload, a smaller one its PutObject. A part waits for
its upload's Create and the Complete for every part, holding its worker,
so up to `clients` parts of one upload or of two are in flight and a
Complete keeps its worker from the parts behind it. A worker that finds
the FIFO empty opens the next object. Without "multipart" every object
is one PutObject and the loop is a plain closed loop.

A request record is [index, start s, end s, bytes, status, verified],
times from the window's opening (negative in the ramp): an UploadPart
carries its part's bytes, CreateMultipartUpload and
CompleteMultipartUpload 0. An upload is [index, size, parts, the
Complete's status, its ETag check, its start and end] (None where the
Complete was never sent).
PutObject and UploadPart ETags are held against the MD5 of the body,
and a Complete's against S3's rule over the parts' MD5s, once the window
has drained; GET bodies are compared byte for byte with the fill object
as they arrive."""

from __future__ import annotations

import collections
import hashlib
import http.client
import json
import sys
import threading
import time

from portbench import reference, sigv4, traffic

ERRORS = (OSError, http.client.HTTPException)
FORGED_PUTS = 2
# the parts of a warm-up upload: two, each the mix's part size or 1 MiB,
# whichever is smaller
WARM_PART = 1 << 20


def emit(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj, separators=(",", ":")) + "\n")
    sys.stdout.flush()


class Upload:
    """One multipart upload of the window: its parts' sizes, its upload
    id (None while its Create is in flight, "" where it failed), the
    ETags its UploadParts returned, how many have yet to finish, and,
    once the window has drained, the reference MD5 of each part."""

    def __init__(self, i: int, size: int, parts: list[int]):
        self.i, self.size, self.parts = i, size, parts
        self.id = None
        self.etags: list = [None] * len(parts)
        self.left = len(parts)
        self.md5s: list = [None] * len(parts)
        self.complete = None  # the Complete's status; None: never sent
        self.etag = ""
        self.rec = None  # the Complete's record

    def entry(self) -> list:
        """[index, size, parts, the Complete's status, its ETag check,
        its start and end s], the last three None where it was never
        sent."""
        sent = self.rec is not None
        return [self.i, self.size, len(self.parts), self.complete,
                self.rec[5] if self.complete == 200 else None,
                self.rec[1] if sent else None, self.rec[2] if sent else None]


class LoadGen:
    def __init__(self, p: dict):
        self.p = p
        self.spec = p["traffic"]
        self.plan = traffic.Plan(self.spec, p["seed"])
        self.signer = sigv4.Signer(p["key_id"], p["secret"], p["region"])
        self.bucket = p["bucket"]
        self.clients = [sigv4.Client(p["host"], p["port"], self.signer)
                        for _ in range(self.spec["clients"])]
        self.fill_bodies: dict[int, bytes] = {}
        self.fill_md5: dict[int, str] = {}
        self.etags: dict[int, str] = {}
        self.uploads: list[Upload] = []

    def path(self, key: str) -> str:
        return f"/{self.bucket}/{key}"

    # ---- one request -----------------------------------------------------

    def put(self, c: sigv4.Client, key: str, body: bytes,
            forge_chunk=None, query=()) -> tuple[float, float, int, str]:
        """-> (start, end, status, etag); the clock runs from the first
        byte sent to the last byte of the reply. With `query` an
        UploadPart."""
        path = self.path(key)
        if self.spec.get("payload") == "signed":
            ck = self.spec["chunk"]
            chunks = [body[j:j + ck] for j in range(0, len(body), ck)]
            headers, wire = c.signed_chunked_body(path, chunks, forge_chunk,
                                                  query)
            t0 = time.perf_counter()
            st, hdr, _ = c.put_signed(path, headers, wire, query)
        else:
            t0 = time.perf_counter()
            st, hdr, _ = c.put_unsigned(path, body, query)
        return t0, time.perf_counter(), st, hdr.get("etag", "").strip('"')

    def put_part(self, c: sigv4.Client, key: str, upload_id: str, n: int,
                 body: bytes) -> tuple[float, float, int, str]:
        return self.put(c, key, body, query=[("partNumber", str(n)),
                                             ("uploadId", upload_id)])

    def get(self, c: sigv4.Client, j: int) -> tuple[float, float, int, bool]:
        t0 = time.perf_counter()
        st, hdr, body = c.get(self.path(self.plan.fill_key(j)))
        t1 = time.perf_counter()
        ok = (st == 200 and body == self.fill_bodies[j]
              and hdr.get("etag", "").strip('"') == self.fill_md5[j])
        return t0, t1, st, ok

    # ---- phases --------------------------------------------------------

    def _run_clients(self, work) -> None:
        threads = [threading.Thread(target=work, args=(c,), daemon=True)
                   for c in self.clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def fill(self) -> dict:
        n = self.plan.fill_count
        nxt, lock, bad = iter(range(n)), threading.Lock(), []

        def work(c):
            while True:
                with lock:
                    j = next(nxt, None)
                if j is None:
                    return
                body = self.plan.body("fill", j, self.plan.fill_size(j))
                md5 = hashlib.md5(body).hexdigest()
                try:
                    st, hdr, _ = c.put_unsigned(
                        self.path(self.plan.fill_key(j)), body)
                except ERRORS as e:
                    st, hdr = 0, {"error": repr(e)}
                if st != 200 or hdr.get("etag", "").strip('"') != md5:
                    bad.append([j, st])
                self.fill_bodies[j], self.fill_md5[j] = body, md5

        t = time.perf_counter()
        self._run_clients(work)
        return {"objects": n, "bad": bad,
                "bytes": sum(len(b) for b in self.fill_bodies.values()),
                "seconds": time.perf_counter() - t}

    def _warm_upload(self, c: sigv4.Client, i: int):
        """One multipart upload of two small parts: every request of the
        multipart path, at a fraction of the window's sizes."""
        key = f"w{i:03d}"
        size = min(self.spec["multipart"]["part_size"], WARM_PART)
        st, _, uid = c.create_multipart(self.path(key))
        etags = []
        for n in (1, 2):
            if st != 200:
                return st
            body = self.plan.body("warm", 1024 * (i + 1) + n, size)
            _t0, _t1, st, etag = self.put_part(c, key, uid, n, body)
            etags.append(etag)
        if st == 200:
            st, _, _ = c.complete_multipart(self.path(key), uid, etags)
        return st

    def warm(self) -> dict:
        op = self.spec["op"]
        sizes, out = self.plan.sizes, []

        def work(c):
            i = self.clients.index(c)
            try:
                if op == "put" and self.spec.get("multipart"):
                    st = self._warm_upload(c, i)
                elif op == "put":
                    size = sizes[(i * 7) % len(sizes)]
                    body = self.plan.body("warm", i, size)
                    _t0, _t1, st, _ = self.put(c, f"w{i:03d}", body)
                else:
                    _t0, _t1, st, _ = self.get(c, i % self.plan.fill_count)
            except ERRORS as e:
                st = repr(e)
            out.append(st)

        self._run_clients(work)
        return {"statuses": out}

    def window(self, seconds: float, ramp: float) -> None:
        """The loop runs `ramp` seconds before the window opens, so that
        the window sees the loop's steady state and not its start, where
        every client sends at once."""
        records: list = []
        parts: list = []  # (record, upload, n, etag) of every UploadPart
        first = time.perf_counter()
        start = first + ramp
        close = start + seconds
        if self.spec.get("multipart"):
            work = self._task_loop(threading.Condition(), records, parts,
                                   start, close)
        else:
            work = self._closed_loop(threading.Lock(), records, start, close)
        threads = [threading.Thread(target=work, args=(c,), daemon=True)
                   for c in self.clients]
        for t in threads:
            t.start()
        time.sleep(max(0.0, start - time.perf_counter()))
        emit({"event": "window_start", "wall": time.time()})
        time.sleep(max(0.0, close - time.perf_counter()))
        emit({"event": "window_end"})
        for t in threads:
            t.join()
        drained = time.perf_counter() - start
        if self.spec["op"] == "put":
            self._verify(records, parts)
        emit({"event": "window_done", "records": records,
              "uploads": [up.entry() for up in self.uploads],
              "seconds": seconds, "drained_s": drained})

    def _closed_loop(self, lock, records: list, start: float, close: float):
        """Each client sends its next request when its reply is in; at
        the close it starts no other."""
        op = self.spec["op"]
        counter = iter(range(1 << 40))

        def work(c):
            while True:
                with lock:
                    i = next(counter)
                t0 = time.perf_counter()
                if t0 >= close:
                    return
                if op == "put":
                    idx, size = i, self.plan.put_size(i)
                else:
                    idx = self.plan.get_target(i)
                    size = len(self.fill_bodies[idx])
                try:
                    if op == "put":
                        body = self.plan.body("put", i, size)
                        t0, t1, st, etag = self.put(
                            c, self.plan.put_key(i), body)
                        self.etags[i] = etag
                        ok = None
                    else:
                        t0, t1, st, ok = self.get(c, idx)
                except ERRORS:
                    t1, st, ok = time.perf_counter(), 0, False
                rec = [idx, t0 - start, t1 - start, size, st, ok]
                with lock:
                    records.append(rec)
        return work

    def _task_loop(self, lock, records: list, parts: list, start: float,
                   close: float):
        """s3transfer's executor: the clients are workers that take tasks
        from one FIFO in order. The FIFO holds every task of the objects
        opened, object by object: a PutObject, or an upload's Create, its
        parts and its Complete. The AWS CLI queues up to 1,000 tasks
        ahead of its workers, more than a run takes, so a worker that
        finds the FIFO empty opens the next object. A part waits for its
        upload's Create, and the Complete for every part, each holding
        its worker as s3transfer's tasks do. After the close no object
        opens; the tasks of those opened run to their end."""
        queue: collections.deque = collections.deque()
        counter = iter(range(1 << 40))

        def open_next():
            i = next(counter)
            size = self.plan.put_size(i)
            sizes = self.plan.part_sizes(size)
            if sizes is None:
                queue.append(("put", i, size))
                return
            up = Upload(i, size, sizes)
            queue.append(("create", up))
            queue.extend(("part", up, n) for n in range(1, len(sizes) + 1))
            queue.append(("complete", up))

        def take():
            """The next task, its dependencies met; None at the end."""
            with lock:
                if not queue and time.perf_counter() < close:
                    open_next()
                if queue and queue[0][0] in ("put", "create") and \
                        time.perf_counter() >= close:
                    queue.clear()  # every task left is of an object not opened
                if not queue:
                    return None
                task = queue.popleft()
                if task[0] == "part":
                    while task[1].id is None:
                        lock.wait()
                elif task[0] == "complete":
                    while task[1].left:
                        lock.wait()
                return task

        def put_object(c, i, size):
            body = self.plan.body("put", i, size)
            t0 = time.perf_counter()
            try:
                t0, t1, st, etag = self.put(c, self.plan.put_key(i), body)
                self.etags[i] = etag
            except ERRORS:
                t1, st = time.perf_counter(), 0
            with lock:
                records.append([i, t0 - start, t1 - start, size, st, None])

        def create(c, up):
            t0 = time.perf_counter()
            try:
                st, _, uid = c.create_multipart(
                    self.path(self.plan.put_key(up.i)))
            except ERRORS:
                st, uid = 0, ""
            with lock:
                records.append([up.i, t0 - start,
                                time.perf_counter() - start, 0, st, None])
                up.id = uid if st == 200 else ""
                if up.id:
                    self.uploads.append(up)
                lock.notify_all()

        def part(c, up, n):
            if not up.id:  # its Create failed, and counts
                with lock:
                    up.left -= 1
                    lock.notify_all()
                return
            size = up.parts[n - 1]
            body = self.plan.part_body(up.i, n, size)
            t0 = time.perf_counter()
            try:
                t0, t1, st, etag = self.put_part(
                    c, self.plan.put_key(up.i), up.id, n, body)
            except ERRORS:
                t1, st, etag = time.perf_counter(), 0, ""
            rec = [up.i, t0 - start, t1 - start, size, st, None]
            with lock:
                records.append(rec)
                parts.append((rec, up, n, etag))
                if st == 200:
                    up.etags[n - 1] = etag
                up.left -= 1
                lock.notify_all()

        def complete(c, up):
            if not up.id or None in up.etags:
                return  # the upload stays incomplete, and counts
            t0 = time.perf_counter()
            try:
                st, _, etag = c.complete_multipart(
                    self.path(self.plan.put_key(up.i)), up.id, up.etags)
            except ERRORS:
                st, etag = 0, ""
            rec = [up.i, t0 - start, time.perf_counter() - start, 0, st, None]
            with lock:
                records.append(rec)
                up.complete, up.etag, up.rec = st, etag, rec

        run = {"put": put_object, "create": create, "part": part,
               "complete": complete}

        def work(c):
            while (task := take()) is not None:
                run[task[0]](c, *task[1:])
        return work

    def _verify(self, records: list, parts: list) -> None:
        """ETag = MD5 of the body, for every PutObject and UploadPart
        acknowledged; a completed upload's ETag = S3's rule over its
        parts' MD5s."""
        uploaded = {up.i for up in self.uploads}
        for rec in records:
            if rec[4] == 200 and rec[0] not in uploaded:
                body = self.plan.body("put", rec[0], rec[3])
                rec[5] = (hashlib.md5(body).hexdigest()
                          == self.etags.get(rec[0]))
        for rec, up, n, etag in parts:
            if rec[4] == 200:
                md5 = hashlib.md5(
                    self.plan.part_body(up.i, n, rec[3])).digest()
                up.md5s[n - 1] = md5
                rec[5] = md5.hex() == etag
        for up in self.uploads:
            if up.complete == 200:
                up.rec[5] = up.etag == reference.multipart_etag(up.md5s)

    def readback(self) -> dict:
        """GetObject of one completed upload, the smallest of two parts
        or more (of one where there is none): its body against its
        parts' bodies in order, its ETag against S3's rule over the
        parts' MD5s."""
        done = [up for up in self.uploads if up.complete == 200]
        if not done:
            return {"index": None}
        up = min([u for u in done if len(u.parts) >= 2] or done,
                 key=lambda u: (u.size, u.i))
        t = time.perf_counter()
        try:
            st, hdr, body = self.clients[0].get(
                self.path(self.plan.put_key(up.i)))
        except ERRORS:
            st, hdr, body = 0, {}, b""
        ok = (st == 200 and body == b"".join(
            self.plan.part_body(up.i, n, size)
            for n, size in enumerate(up.parts, 1))
            and hdr.get("etag", "").strip('"')
            == reference.multipart_etag(up.md5s))
        return {"index": up.i, "size": up.size, "parts": len(up.parts),
                "status": st, "ok": ok, "seconds": time.perf_counter() - t}

    def probe(self) -> dict:
        """Signed PUTs of three 64 KiB chunks, the second chunk's
        signature forged: the server must refuse each."""
        statuses = []
        for n in range(FORGED_PUTS):
            body = self.plan.body("probe", n, 3 * self.spec["chunk"])
            try:
                _t0, _t1, st, _ = self.put(self.clients[0], f"x{n:03d}",
                                           body, forge_chunk=1)
            except ERRORS:
                st = 0
            statuses.append(st)
        return {"statuses": statuses}


def main() -> int:
    p = json.loads(sys.stdin.readline())
    gen = LoadGen(p)
    emit({"event": "ready"})
    for line in sys.stdin:
        cmd = json.loads(line)
        what = cmd["cmd"]
        if what == "fill":
            emit({"event": "filled", **gen.fill()})
        elif what == "warm":
            emit({"event": "warmed", **gen.warm()})
        elif what == "window":
            gen.window(float(cmd["seconds"]), float(cmd.get("ramp", 0.0)))
        elif what == "readback":
            emit({"event": "read_back", **gen.readback()})
        elif what == "probe":
            emit({"event": "probed", **gen.probe()})
        elif what == "quit":
            break
    for c in gen.clients:
        c.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
