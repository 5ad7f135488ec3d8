"""Worker functions that tests start in spawned processes. A spawned child
imports the module of its function; this one imports torch and the port
only, so a child starts in seconds (a test module would import JAX)."""

import torch


def consensus_worker(rank, port, flags, out):
    """Join a 2-process gloo group and put (rank, the stop consensus of each
    of ``flags[rank]``) on ``out``."""
    import torch.distributed as dist

    from gst_tacotron_tpu_torch.decode import data_parallel_stop_consensus

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        reduce = data_parallel_stop_consensus()
        out.put((rank, [reduce(torch.tensor(f)).tolist() for f in flags[rank]]))
    finally:
        dist.destroy_process_group()
