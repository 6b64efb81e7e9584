"""S3 front end: the time a PUT waits for its body, over its time.
The sum of s3.put.first_read_and_lookup (the first block, read beside
the object lookup) and s3.put.chunk_read spans (each later block; in a
signed PUT, each chunk's digest and signature check included) over the
sum of the http.request spans of the window's PUTs, in %."""

READ = ("s3.put.first_read_and_lookup", "s3.put.chunk_read")


def read(r):
    puts = {s["trace"]: s["dur_us"] for s in r.spans
            if s["name"] == "http.request"
            and (s.get("attrs") or {}).get("method") == "PUT"}
    if not puts:
        return None
    wait = sum(s["dur_us"] for s in r.spans
               if s["name"] in READ and s["trace"] in puts)
    return 100.0 * wait / sum(puts.values())
