"""Offline OSD store surgery — the ceph-objectstore-tool analog
(src/tools/ceph_objectstore_tool.cc).

Operates directly on one OSD's store directory while the daemon is
DOWN (the tool's defining property: it bypasses the cluster entirely):

    python -m ceph_tpu_torch.objectstore_tool --data-path /c/osd.0 --op list
    python -m ceph_tpu_torch.objectstore_tool --data-path /c/osd.0 \
        --op info 1:obj#s2
    python -m ceph_tpu_torch.objectstore_tool --data-path /c/osd.0 \
        --op export --file dump.bin [objects...]
    python -m ceph_tpu_torch.objectstore_tool --data-path /c/osd.1 \
        --op import --file dump.bin
    python -m ceph_tpu_torch.objectstore_tool --data-path /c/osd.0 \
        --op remove 1:obj#s2
    python -m ceph_tpu_torch.objectstore_tool --data-path /c/osd.0 --op fsck

ops mirrored from the reference: ``list`` (JSON lines, one per
object), ``info`` (size + parsed OI eversion + attrs + hinfo CRCs),
``export``/``import`` (portable crc-framed object archive — the
export/import used to salvage PG shards between OSDs), ``remove``,
and ``fsck`` (read every byte back; BlockStore csum verification makes
this the BlueStore-fsck deep mode).

Export format: one crc-framed record (store/framed_log) per object,
payload = JSON {oid, size, attrs{hex}} + b"\\0" + raw data. The
per-record crc32c gives the archive the same torn/corrupt detection
the stores' own WALs have. Stores and archives are ``ceph_tpu``'s
formats: either package's tool reads what the other wrote. ``--device``
(``cuda`` unless the caller asks for the CPU) is where ``info``'s
HashInfo lives.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from ceph_tpu_torch.store import framed_log


def open_store(data_path: str):
    from ceph_tpu_torch.store import open_store as _open

    return _open(data_path)


def _obj_row(store, oid: str) -> dict:
    row: dict = {"oid": oid, "bytes": store.stat(oid)}
    try:
        from ceph_tpu_torch.pipeline.rmw import OI_KEY, parse_oi

        size, ev = parse_oi(store.getattr(oid, OI_KEY))
        row["ro_size"] = size
        row["eversion"] = list(ev)
    except (FileNotFoundError, KeyError, ValueError):
        pass
    return row


def op_list(store, args) -> int:
    for oid in store.list_objects():
        print(json.dumps(_obj_row(store, oid)))
    return 0


def op_info(store, args) -> int:
    if not args.objects:
        print("info needs an object name", file=sys.stderr)
        return 2
    rc = 0
    for oid in args.objects:
        if not store.exists(oid):
            print(f"{oid}: not found", file=sys.stderr)
            rc = 1
            continue
        row = _obj_row(store, oid)
        attrs = store.getattrs(oid)
        row["attrs"] = {k: v.hex() for k, v in sorted(attrs.items())}
        try:
            from ceph_tpu_torch.pipeline.hashinfo import HashInfo
            from ceph_tpu_torch.pipeline.rmw import HINFO_KEY

            hinfo = HashInfo.from_bytes(attrs[HINFO_KEY], args.device)
            row["hinfo"] = {
                "total_chunk_size": hinfo.total_chunk_size,
                "cumulative_shard_crcs": [
                    hex(h) for h in hinfo.cumulative_shard_hashes
                ],
            }
        except (KeyError, ValueError):
            pass
        print(json.dumps(row))
    return rc


def op_export(store, args) -> int:
    if not args.file:
        print("export needs --file", file=sys.stderr)
        return 2
    oids = args.objects or store.list_objects()
    # build in a temp file so a failed export never leaves a torn
    # archive under the target name
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(args.file) or ".")
    os.close(fd)
    try:
        n = 0
        for oid in oids:
            if not store.exists(oid):
                print(f"{oid}: not found", file=sys.stderr)
                return 1
            data = store.read(oid)
            attrs = store.getattrs(oid)
            hdr = json.dumps(
                {
                    "oid": oid,
                    "size": len(data),
                    "attrs": {k: v.hex() for k, v in attrs.items()},
                }
            ).encode()
            framed_log.append(tmp, hdr + b"\0" + data, sync=False)
            n += 1
        os.replace(tmp, args.file)
    finally:
        if os.path.exists(tmp):  # any non-success path
            os.unlink(tmp)
    print(f"exported {n} objects to {args.file}")
    return 0


def op_import(store, args) -> int:
    from ceph_tpu_torch.store import Transaction

    if not args.file or not os.path.exists(args.file):
        print("import needs an existing --file", file=sys.stderr)
        return 2
    with open(args.file, "rb") as f:
        raw = f.read()
    records, valid_end = framed_log.scan(raw)
    corrupt = valid_end != len(raw)
    if corrupt:
        print(
            f"archive corrupt past byte {valid_end}; importing the "
            "valid prefix only", file=sys.stderr,
        )
    # Pre-pass conflict check so the import is all-or-nothing: a
    # mid-archive abort after earlier records applied would leave the
    # store half-restored while reporting failure.
    if not args.force:
        clashes = []
        for payload in records:
            hdr_raw, _, _data = payload.partition(b"\0")
            oid = json.loads(hdr_raw.decode())["oid"]
            if store.exists(oid):
                clashes.append(oid)
        if clashes:
            for oid in clashes:
                print(
                    f"{oid}: exists (--force overwrites)", file=sys.stderr
                )
            return 1
    n = 0
    for payload in records:
        hdr_raw, _, data = payload.partition(b"\0")
        hdr = json.loads(hdr_raw.decode())
        oid = hdr["oid"]
        txn = Transaction().touch(oid)
        if store.exists(oid):
            txn.remove(oid).touch(oid)
        if data:
            txn.write(oid, 0, data)
        txn.truncate(oid, hdr["size"])
        for name, hexval in hdr["attrs"].items():
            txn.setattr(oid, name, bytes.fromhex(hexval))
        store.queue_transactions(txn)
        n += 1
    print(f"imported {n} objects")
    # a corrupt archive is a failed restore even though the valid
    # prefix was applied: scripts gating on the exit code must notice
    return 1 if corrupt else 0


def op_remove(store, args) -> int:
    from ceph_tpu_torch.store import Transaction

    if not args.objects:
        print("remove needs object names", file=sys.stderr)
        return 2
    missing = [oid for oid in args.objects if not store.exists(oid)]
    if missing:  # all-or-nothing: fail before touching anything
        for oid in missing:
            print(f"{oid}: not found", file=sys.stderr)
        return 1
    for oid in args.objects:
        store.queue_transactions(Transaction().remove(oid))
        print(f"removed {oid}")
    return 0


def op_fsck(store, args) -> int:
    """Read every object fully (BlockStore verifies per-blob CRCs on
    read — the BlueStore fsck deep mode) and parse identity attrs."""
    bad = 0
    oids = store.list_objects()
    for oid in oids:
        try:
            store.read(oid)
        except Exception as e:
            print(f"{oid}: data error: {e}")
            bad += 1
            continue
        try:
            from ceph_tpu_torch.pipeline.rmw import OI_KEY, parse_oi

            raw = store.getattrs(oid).get(OI_KEY)
            if raw is not None:
                parse_oi(raw)
        except ValueError as e:
            print(f"{oid}: corrupt OI attr: {e}")
            bad += 1
    print(f"fsck: {len(oids)} objects, {bad} errors")
    return 0 if bad == 0 else 1


OPS = {
    "list": op_list,
    "info": op_info,
    "export": op_export,
    "import": op_import,
    "remove": op_remove,
    "fsck": op_fsck,
}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="ceph_tpu_torch.objectstore_tool",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("--data-path", required=True, help="OSD store dir")
    p.add_argument("--op", required=True, choices=sorted(OPS))
    p.add_argument("--file", help="archive path for export/import")
    p.add_argument(
        "--force", action="store_true",
        help="import: overwrite existing objects",
    )
    p.add_argument("objects", nargs="*", help="object names (store keys)")
    p.add_argument("--device", default="cuda",
                   help="device of the HashInfo `info` parses (cuda, or cpu)")
    args = p.parse_args(argv)
    from ceph_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    if not os.path.isdir(args.data_path):
        print(f"no store at {args.data_path}", file=sys.stderr)
        return 2
    store = open_store(args.data_path)
    try:
        return OPS[args.op](store, args)
    except BrokenPipeError:
        # output piped into head/less that exited: normal CLI usage
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0
    finally:
        if hasattr(store, "close"):
            store.close()


if __name__ == "__main__":
    sys.exit(main())
