"""Serving beyond one device (port of ``granne_tpu/parallel``): process
groups and the launcher (``mesh``), IVF blocks split over ranks
(``sharded_ivf.ShardedIvf``), element-sharded HNSW sub-indexes
(``sharded.ShardedGranne``), IVF blocks in host memory streamed to the card
(``tiering.TieredIvf``) and split over ranks (``tiering.TieredShardedIvf``),
and the multi-device dry run (``dryrun``)."""
