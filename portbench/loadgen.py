"""The load generator: a process of its own, so that client signing and
sockets never share the nodes' interpreter lock, as a deployment's
clients sit on other hosts.

    python3 -m portbench.loadgen     (from the checkout root)

It reads one JSON object a line on standard input (the first the run's
parameters, then commands) and answers with one JSON object a line on
standard output. Commands:

- fill:   PUT the mix's fill objects, unsigned, with every client;
- warm:   each client sends one request of the window's kind;
- window: a closed loop of `clients` clients; each sends its next
          request when its reply is in. The loop runs `ramp` seconds,
          then the window opens for `seconds` seconds. At the close no
          client starts another; the ones in flight are waited for.
          Prints window_start and window_end as they happen, then
          window_done with every request, the ramp's included;
- probe:  signed PUTs whose second chunk carries a forged signature;
- quit.

A request record is [index, start s, end s, bytes, status, verified],
times from the window's opening (negative in the ramp). PUT bodies'
ETags are held against the MD5 of the body once the window has drained;
GET bodies are compared byte for byte with the fill object as they
arrive."""

from __future__ import annotations

import hashlib
import http.client
import json
import sys
import threading
import time

from portbench import sigv4, traffic

ERRORS = (OSError, http.client.HTTPException)
FORGED_PUTS = 2


def emit(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj, separators=(",", ":")) + "\n")
    sys.stdout.flush()


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

    def path(self, key: str) -> str:
        return f"/{self.bucket}/{key}"

    # ---- one request -----------------------------------------------------

    def put(self, c: sigv4.Client, key: str, body: bytes,
            forge_chunk=None) -> tuple[float, float, int, str]:
        """-> (start, end, status, etag); the clock runs from the first
        byte sent to the last byte of the reply."""
        path = self.path(key)
        if self.spec.get("payload") == "signed":
            ck = self.spec["chunk"]
            chunks = [body[j:j + ck] for j in range(0, len(body), ck)]
            headers, wire = c.signed_chunked_body(path, chunks, forge_chunk)
            t0 = time.perf_counter()
            st, hdr, _ = c.put_signed(path, headers, wire)
        else:
            t0 = time.perf_counter()
            st, hdr, _ = c.put_unsigned(path, body)
        return t0, time.perf_counter(), st, hdr.get("etag", "").strip('"')

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

    def warm(self) -> dict:
        op = self.spec["op"]
        sizes, out = self.plan.sizes, []

        def work(c):
            i = self.clients.index(c)
            try:
                if op == "put":
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
        """The closed loop runs `ramp` seconds before the window opens,
        so that the window sees the loop's steady state and not its
        start, where every client sends at once."""
        op = self.spec["op"]
        lock = threading.Lock()
        counter = iter(range(1 << 40))
        records: list = []
        first = time.perf_counter()
        start = first + ramp
        close = start + seconds

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
        if op == "put":
            # ETag = MD5 of the body, for every PUT acknowledged
            for rec in records:
                if rec[4] == 200:
                    body = self.plan.body("put", rec[0], rec[3])
                    rec[5] = (hashlib.md5(body).hexdigest()
                              == self.etags.get(rec[0]))
        emit({"event": "window_done", "records": records,
              "seconds": seconds, "drained_s": drained})

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
        elif what == "probe":
            emit({"event": "probed", **gen.probe()})
        elif what == "quit":
            break
    for c in gen.clients:
        c.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
