"""Tables and RPC: the share of the window's Completes spent re-pointing
block refs to the final version (one quorum insert a block): the sum of
the s3.mpu.ref_repoint spans inside the window's s3.mpu.complete spans
over the sum of those, in %."""


def read(r):
    done = {s["span"]: s["dur_us"] for s in r.spans
            if s["name"] == "s3.mpu.complete"}
    total = sum(done.values())
    if total <= 0:
        return None
    repoint = sum(s["dur_us"] for s in r.spans
                  if s["name"] == "s3.mpu.ref_repoint"
                  and s["parent"] in done)
    return 100.0 * repoint / total
