"""Copy of garage_tpu/model/helper.py: import paths rewritten, issue and PR tags dropped.

Bucket/key helpers and locked control-plane mutations.

Ref parity: src/model/helper/{bucket,key,locked}.rs. Reads resolve
aliases and check liveness; mutations that touch the bucket/key/alias
triangle are serialized under `garage.bucket_lock` (the reference's
single global lock, garage.rs:61) so alias updates never race.
"""

from __future__ import annotations

from typing import Optional

from ..utils.crdt import Deletable, Lww, now_msec
from ..utils.error import BadRequest, NoSuchBucket, NoSuchKey
from .bucket_alias_table import BucketAlias
from .bucket_table import Bucket, is_valid_bucket_name
from .key_table import Key
from .permission import BucketKeyPerm


class GarageHelper:
    def __init__(self, garage):
        self.g = garage

    # ---- reads ---------------------------------------------------------

    async def resolve_global_bucket_name(self, name: str) -> Optional[bytes]:
        """Alias or 64-hex bucket id -> bucket id
        (ref: helper/bucket.rs resolve_global_bucket_name)."""
        if len(name) == 64:
            try:
                return bytes.fromhex(name)
            except ValueError:
                pass
        alias = await self.g.bucket_alias_table.get(b"", name.encode())
        if alias is not None and alias.bucket_id is not None:
            return alias.bucket_id
        return None

    async def get_existing_bucket(self, bucket_id: bytes) -> Bucket:
        b = await self.g.bucket_table.get(bucket_id, b"")
        if b is None or b.is_deleted:
            raise NoSuchBucket(bucket_id.hex())
        return b

    async def get_existing_key(self, key_id: str) -> Key:
        k = await self.g.key_table.get(b"", key_id.encode())
        if k is None or k.is_deleted:
            raise NoSuchKey(key_id)
        return k

    async def key_secret(self, key_id: str) -> Optional[str]:
        """SigV4 secret lookup."""
        k = await self.g.key_table.get(b"", key_id.encode())
        if k is None or k.is_deleted or k.params is None:
            return None
        return k.params.secret_key

    async def list_buckets(self, limit: int = 1000) -> list[BucketAlias]:
        return [
            a for a in await self.g.bucket_alias_table.get_range(
                b"", limit=limit)
            if not a.is_deleted
        ]

    async def list_keys(self, limit: int = 1000) -> list[Key]:
        return [
            k for k in await self.g.key_table.get_range(b"", limit=limit)
            if not k.is_deleted
        ]

    # ---- locked mutations (ref: helper/locked.rs) ----------------------

    async def create_bucket(self, name: str) -> Bucket:
        if not is_valid_bucket_name(name):
            raise BadRequest(f"invalid bucket name {name!r}")
        async with self.g.bucket_lock:
            existing = await self.resolve_global_bucket_name(name)
            if existing is not None:
                raise BadRequest(f"bucket {name!r} already exists")
            bucket = Bucket.new()
            params = bucket.params
            params.aliases = params.aliases.insert(name, True)
            bucket = bucket.with_params(params)
            await self.g.bucket_table.insert(bucket)
            await self.g.bucket_alias_table.insert(
                BucketAlias(name, Lww.new(bucket.id)))
            return bucket

    async def delete_bucket(self, bucket_id: bytes) -> None:
        """Only empty buckets can go (ref: helper/bucket.rs
        delete_bucket)."""
        async with self.g.bucket_lock:
            bucket = await self.get_existing_bucket(bucket_id)
            objs = await self.g.object_table.get_range(
                bucket_id, flt={"type": "data"}, limit=1)
            if objs:
                raise BadRequest("bucket is not empty")
            params = bucket.params
            # drop aliases, then tombstone the bucket
            for alias, held in list(params.aliases.items()):
                if held:
                    await self.g.bucket_alias_table.insert(
                        BucketAlias(alias, Lww.new(None)))
            await self.g.bucket_table.insert(
                Bucket(bucket.id, Deletable.deleted()))

    async def create_key(self, name: str = "") -> Key:
        k = Key.new(name)
        await self.g.key_table.insert(k)
        return k

    async def delete_key(self, key_id: str) -> None:
        async with self.g.bucket_lock:
            key = await self.get_existing_key(key_id)
            # revoke from all buckets it was authorized on
            for bid, perm in list(key.params.authorized_buckets.items()):
                if perm.is_any:
                    await self._set_perm_unlocked(bid, key_id,
                                                  BucketKeyPerm(now_msec()))
            await self.g.key_table.insert(Key.deleted(key_id))

    async def set_key_create_bucket(self, key_id: str, allow: bool) -> None:
        """Grant/revoke the global create-bucket permission
        (ref: helper/key.rs set_allow_create_bucket)."""
        async with self.g.bucket_lock:
            key = await self.get_existing_key(key_id)
            kp = key.params
            kp.allow_create_bucket = kp.allow_create_bucket.update(allow)
            await self.g.key_table.insert(
                Key(key_id, Deletable.present(kp)))

    async def set_bucket_key_permissions(self, bucket_id: bytes,
                                         key_id: str,
                                         perm: BucketKeyPerm) -> None:
        async with self.g.bucket_lock:
            await self._set_perm_unlocked(bucket_id, key_id, perm)

    async def global_alias_bucket(self, bucket_id: bytes,
                                  alias: str) -> None:
        """Point a global alias at a bucket (ref: helper/bucket.rs
        set_global_bucket_alias)."""
        if not is_valid_bucket_name(alias):
            raise BadRequest(f"invalid alias name {alias!r}")
        async with self.g.bucket_lock:
            existing = await self.resolve_global_bucket_name(alias)
            if existing is not None and existing != bucket_id:
                raise BadRequest(f"alias {alias!r} already in use")
            bucket = await self.get_existing_bucket(bucket_id)
            params = bucket.params
            params.aliases = params.aliases.insert(alias, True)
            await self.g.bucket_table.insert(bucket.with_params(params))
            await self.g.bucket_alias_table.insert(
                BucketAlias(alias, Lww.new(bucket_id)))

    async def global_unalias_bucket(self, bucket_id: bytes,
                                    alias: str) -> None:
        async with self.g.bucket_lock:
            cur = await self.resolve_global_bucket_name(alias)
            if cur != bucket_id:
                raise BadRequest(
                    f"alias {alias!r} does not point to this bucket")
            bucket = await self.get_existing_bucket(bucket_id)
            params = bucket.params
            live = [a for a, v in params.aliases.items() if v and a != alias]
            has_local = any(v for _, v in params.local_aliases.items())
            if not live and not has_local:
                raise BadRequest(
                    "cannot remove the bucket's last alias")
            params.aliases = params.aliases.insert(alias, False)
            await self.g.bucket_table.insert(bucket.with_params(params))
            await self.g.bucket_alias_table.insert(
                BucketAlias(alias, Lww.new(None)))

    async def local_alias_bucket(self, bucket_id: bytes, key_id: str,
                                 alias: str) -> None:
        """Key-local bucket alias (ref: helper/bucket.rs
        set_local_bucket_alias)."""
        if not is_valid_bucket_name(alias):
            raise BadRequest(f"invalid alias name {alias!r}")
        async with self.g.bucket_lock:
            bucket = await self.get_existing_bucket(bucket_id)
            key = await self.get_existing_key(key_id)
            kp = key.params
            cur = kp.local_aliases.get(alias)
            if cur is not None and cur != bucket_id:
                raise BadRequest(f"local alias {alias!r} already in use")
            kp.local_aliases = kp.local_aliases.insert(alias, bucket_id)
            await self.g.key_table.insert(
                Key(key_id, Deletable.present(kp)))
            params = bucket.params
            params.local_aliases = params.local_aliases.insert(
                (key_id, alias), True)
            await self.g.bucket_table.insert(bucket.with_params(params))

    async def local_unalias_bucket(self, bucket_id: bytes, key_id: str,
                                   alias: str) -> None:
        async with self.g.bucket_lock:
            bucket = await self.get_existing_bucket(bucket_id)
            key = await self.get_existing_key(key_id)
            kp = key.params
            if kp.local_aliases.get(alias) != bucket_id:
                raise BadRequest(
                    f"local alias {alias!r} does not point to this bucket")
            params = bucket.params
            live = [a for a, v in params.aliases.items() if v]
            others = [k for k, v in params.local_aliases.items()
                      if v and k != (key_id, alias)]
            if not live and not others:
                raise BadRequest("cannot remove the bucket's last alias")
            kp.local_aliases = kp.local_aliases.insert(alias, None)
            await self.g.key_table.insert(
                Key(key_id, Deletable.present(kp)))
            params.local_aliases = params.local_aliases.insert(
                (key_id, alias), False)
            await self.g.bucket_table.insert(bucket.with_params(params))

    async def update_bucket_config(self, bucket_id: bytes, field: str,
                                   value) -> None:
        """Read-modify-write one Lww config register (website_config /
        cors_config / lifecycle_config / quotas) under the bucket lock
        (ref: api/s3/website.rs + cors.rs update paths through
        helper/locked.rs)."""
        await self.update_bucket_configs(bucket_id, {field: value})

    async def update_bucket_configs(self, bucket_id: bytes,
                                    updates: dict) -> None:
        """Atomically update several Lww config registers in ONE locked
        read-modify-write (admin UpdateBucket sets website + quotas
        together; two separate inserts could persist half on error)."""
        async with self.g.bucket_lock:
            bucket = await self.get_existing_bucket(bucket_id)
            params = bucket.params
            for field, value in updates.items():
                setattr(params, field, getattr(params, field).update(value))
            await self.g.bucket_table.insert(bucket.with_params(params))

    async def _set_perm_unlocked(self, bucket_id: bytes, key_id: str,
                                 perm: BucketKeyPerm) -> None:
        bucket = await self.get_existing_bucket(bucket_id)
        key = await self.get_existing_key(key_id)
        params = bucket.params
        params.authorized_keys = params.authorized_keys.put(key_id, perm)
        await self.g.bucket_table.insert(bucket.with_params(params))
        kp = key.params
        kp.authorized_buckets = kp.authorized_buckets.put(bucket_id, perm)
        await self.g.key_table.insert(Key(key_id, Deletable.present(kp)))


def allow_all(ts: Optional[int] = None) -> BucketKeyPerm:
    return BucketKeyPerm(ts if ts is not None else now_msec(),
                         True, True, True)
