"""S3 front end: mean s3.mpu.complete span (a CompleteMultipartUpload
from its request's parse to its reply: the part check, the splice of
the part versions, the block refs' re-point and the object's insert),
ms."""


def read(r):
    d = [s["dur_us"] for s in r.spans if s["name"] == "s3.mpu.complete"]
    return sum(d) / len(d) / 1e3 if d else None
