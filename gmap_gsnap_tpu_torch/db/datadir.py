"""Device containers for a GMAP/GSNAP database directory.

The port opens databases with the JAX package's host-only loader
(``gmap_gsnap_tpu.db.datadir.GenomeDB``).  That class's
``device_genome`` / ``device_index`` cached properties import the JAX
ops, so these two functions stand in for them.  Like those properties
they cache their result on the database, here per device, so runners
over one database share one copy (at k=15 the offsets alone are 4.3 GB).
"""

from __future__ import annotations

from gmap_gsnap_tpu.db.datadir import GenomeDB

from .. import convert
from ..utils.device import resolve_device


def _cached(db: GenomeDB, what: str, device, make):
    cache = db.__dict__.setdefault("_port_device_arrays", {})
    key = (what, resolve_device(device))
    if key not in cache:
        cache[key] = make(key[1])
    return cache[key]


def device_genome(db: GenomeDB, device):
    """The packed genome of ``db`` on ``device``."""
    return _cached(db, "genome", device, lambda dev: convert.genome_from_host(
        db.codes, db.flags, db.chr_ends, dev))


def device_index(db: GenomeDB, device):
    """The k-mer index of ``db`` on ``device``."""
    if db.offsets is None:
        raise ValueError("database has no k-mer index")
    return _cached(db, "index", device, lambda dev: convert.index_from_arrays(
        db.offsets, db.positions, db.k, db.interval, dev))
