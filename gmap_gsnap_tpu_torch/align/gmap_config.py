"""GMAP run-time knobs (module statics, mirroring the reference's
setup-time globals in gmap.c); a copy of
gmap_gsnap_tpu/align/gmap_config.py.  The JAX package's gmap CLI sets
them before aligning; align/gmap.py and align/gmap_engine.py read them.
"""

# --canonical-mode (gmap.c:259, consumed at :753-761 as do_final_p):
# 0 = low reward for canonical introns (final rewards off),
# 1 = high reward (default), 2 = high reward for low-identity seqs only.
CANONICAL_MODE = 1

# --nosplicing (gmap.c:330 novelsplicingp): genome gaps score as
# noncanonical with no intron rewards.
NOSPLICING = False

# -H/--trimendexons (gmap.c:195 minendexon): trim end exons with fewer
# than this many matches (stage3.c:2327 trim_short_end_exons).
MINENDEXON = 9


def finalp_allowed(finalp: bool) -> bool:
    """Gate FINAL_* canonical rewards by --canonical-mode (mode 2 is
    treated as mode 0 for high-identity queries; our pipeline computes
    identity post hoc, so mode 2 keeps final rewards like mode 1 —
    divergence is limited to low-identity cross-species input)."""
    return finalp and CANONICAL_MODE != 0
