"""Scale-out over devices and files.

The codec is embarrassingly parallel over frames (each FLAC frame is
self-contained), so the layout is a 1-D ``frames`` mesh with batches split
on their leading axis (:mod:`flacx_torch.parallel.mesh`); the corpus
encode (:mod:`flacx_torch.parallel.corpus`) mixes the frames of many files
in each batch.  The multi-process names of the JAX package's
``parallel`` (``init_distributed``, ``global_data_mesh``,
``shard_corpus``, ``allreduce_stats``, ``encode_corpus_distributed``) are
not ported yet and raise ``AttributeError``.
"""

from flacx_torch.parallel.mesh import data_mesh, frame_sharding

__all__ = ["data_mesh", "frame_sharding"]
