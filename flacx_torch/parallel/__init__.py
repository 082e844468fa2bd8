"""Scale-out over devices, processes and files.

The codec is embarrassingly parallel over frames (each FLAC frame is
self-contained), so the layout is a 1-D ``frames`` mesh with batches split
on their leading axis (:mod:`flacx_torch.parallel.mesh`); the corpus
encode (:mod:`flacx_torch.parallel.corpus`) mixes the frames of many files
in each batch.  Across processes (:mod:`flacx_torch.parallel.distributed`,
``torch.distributed`` on gloo) the corpus is striped over the processes
and only five scalars are summed.  For long blocks the sample axis itself
can be cut over a 2-D ``frames`` × ``seq`` mesh with a halo exchange
(:mod:`flacx_torch.parallel.seqshard`, the ``seqshard`` kernel), and
:mod:`flacx_torch.parallel.dryrun` drives every one of these layers on a
mesh of ``n`` devices.
"""

from flacx_torch.parallel.mesh import data_mesh, frame_sharding

__all__ = ["data_mesh", "frame_sharding", "init_distributed",
           "global_data_mesh", "shard_corpus", "allreduce_stats",
           "encode_corpus_distributed"]


def __getattr__(name):
    # lazy: the distributed layer pulls in the corpus and encoder machinery
    if name in ("init_distributed", "global_data_mesh", "shard_corpus",
                "allreduce_stats", "encode_corpus_distributed"):
        from flacx_torch.parallel import distributed
        return getattr(distributed, name)
    raise AttributeError(name)
