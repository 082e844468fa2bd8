"""``flacx_torch.parallel.dryrun.dryrun_multichip`` on a CPU mesh.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
runs every check of it (the sharded batch encode and its oracle round
trip, the sharded file, decode, corpus stripes, the sequence-sharded
autocorrelation on a 2 x 2 ``frames`` × ``seq`` mesh, the uneven batch,
the hi-res file and the corpus through the multi-process layer) on a mesh
of four ``cpu`` entries, with each kernel's plain version, to its one
summary line.
"""

import pytest
import torch

from flacx_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)


def test_dryrun_multichip_on_four_cpu_entries(capsys):
    dryrun_multichip(4, devices=("cpu",) * 4, device="cpu")
    line = capsys.readouterr().out.strip()
    assert line.startswith("dryrun_multichip(4): OK — ")
    assert line.endswith("distributed corpus OK (3 files), seq-parallel "
                         "autocorr OK (halo exchange + shard sum)")


def test_dryrun_multichip_takes_visible_cards_only():
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="visible"):
        dryrun_multichip(visible + 1)
