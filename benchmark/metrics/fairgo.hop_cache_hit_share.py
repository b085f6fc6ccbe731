"""Share of the FairGo model's lookups of its kept filtered table and hops
that hit: 100 × the program's counter ``fairgo.hop_cache_hits`` over
``fairgo.hop_cache_hits`` + ``fairgo.hop_cache_misses``
(``models/fairgo_base.py::calculate_dis_loss``, one lookup a discriminator
step), over the slice, in %. None where the program counts no lookup (a
program without the kept hops, or a slice without a discriminator step)."""

from harness import program


def read(run):
    hits = program.counter("fairgo.hop_cache_hits")
    if hits is None:
        return None
    lookups = hits + program.counter("fairgo.hop_cache_misses")
    return 100.0 * hits / lookups if lookups else None
