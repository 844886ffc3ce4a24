"""Shared by the port's parity tests: hand the JAX package the same
database the port's loader built."""

import dataclasses

from gmap_gsnap_tpu.db import datadir as jdatadir


def jax_db(db):
    """The JAX package's GenomeDB over the arrays of the port's ``db``
    (same fields; the index arrays shared, not re-read), so the JAX
    runner can build its device arrays from it."""
    j = jdatadir.GenomeDB(**{f.name: getattr(db, f.name)
                             for f in dataclasses.fields(db)})
    j.offsets, j.positions = db.offsets, db.positions
    return j
