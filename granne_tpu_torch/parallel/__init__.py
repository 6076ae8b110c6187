"""Work beyond one device (port of ``granne_tpu/parallel``): process groups
and the launcher (``mesh``), the data-parallel HNSW build (``dp_build``:
``build_layers(..., group=...)`` splits each wave over the ranks), IVF
blocks split over ranks (``sharded_ivf.ShardedIvf``), element-sharded HNSW
sub-indexes (``sharded.ShardedGranne``), IVF blocks in host memory streamed
to the card (``tiering.TieredIvf``) and split over ranks
(``tiering.TieredShardedIvf``), and the multi-device dry run (``dryrun``)."""

from . import dp_build  # noqa: F401
