"""Copy of garage_tpu/block/__init__.py: import paths rewritten, issue and PR tags dropped.

Block store: the content-addressed data plane.

Ref parity: src/block/ (SURVEY.md §2.6). Blocks (≤1 MiB by default) are
keyed by the blake2 hash of their plain content and stored as files;
metadata refcounts arrive via the block_ref table trigger; a persistent
resync queue repairs missing/superfluous copies; scrub re-verifies every
stored byte.

TPU-native extension (the north star, BASELINE.md): the `BlockCodec`
boundary generalizes "replicate N whole copies" to "erasure(k, m)
stripes" whose GF(2^8) Reed-Solomon math runs as batched XLA/Pallas ops
(ops/rs.py) — encode on put, decode-any-k on get, parity-check on scrub.
"""

from .block import DataBlock, COMPRESSION_ZLIB, COMPRESSION_ZSTD  # noqa: F401
from .cache import BlockCache  # noqa: F401
from .codec import BlockCodec, ReplicateCodec, ErasureCodec  # noqa: F401
from .layout import DataLayout  # noqa: F401
from .rc import BlockRc  # noqa: F401
from .manager import BlockManager  # noqa: F401
from .resync import BlockResyncManager  # noqa: F401
from .repair import ScrubWorker, RepairWorker  # noqa: F401
