"""Copy of garage_tpu/model/s3/__init__.py: import paths rewritten, issue and PR tags dropped.

S3 object-model tables (object/version/block_ref/multipart)."""

from .block_ref_table import (BlockRef, BlockRefReplication, BlockRefTable,
                              block_ref_recount_fn)
from .mpu_table import MpuPart, MultipartUpload, MultipartUploadTable
from .object_table import (Object, ObjectTable, ObjectVersion,
                           ObjectVersionData, ObjectVersionMeta,
                           ObjectVersionState, object_upload_version)
from .version_table import Version, VersionTable

__all__ = [
    "BlockRef", "BlockRefReplication", "BlockRefTable", "MpuPart",
    "MultipartUpload", "MultipartUploadTable", "Object", "ObjectTable",
    "ObjectVersion", "ObjectVersionData", "ObjectVersionMeta",
    "ObjectVersionState", "Version", "VersionTable",
    "block_ref_recount_fn", "object_upload_version",
]
