"""Copy of garage_tpu/db/__init__.py: import paths rewritten, issue and PR tags dropped.

Embedded KV abstraction: named trees + cross-tree transactions.

Ref parity: src/db/lib.rs (Db/Tree/Transaction facade, on_commit hooks,
snapshot), src/db/sqlite_adapter.rs, src/db/open.rs. LMDB is not
available in this image, so the engines are sqlite (durable default),
memory (tests/sim) and lsm (log-structured merge engine for metadata
at millions of keys — see lsm.py and README "Metadata at scale"). The
same test-suite runs against all engines, mirroring src/db/test.rs.
"""

from .db import Db, Tree, Transaction, TxAbort, blocking_api, open_db

__all__ = ["Db", "Tree", "Transaction", "TxAbort", "blocking_api",
           "open_db"]
