"""Test-support utilities shipped with the port (fault injection)."""

from fps_tpu_torch.testing.chaos import (  # noqa: F401
    bitflip_file,
    corrupt_latest_snapshot,
    kill_at_chunk,
    kill_at_epoch,
    kill_in_prefetch,
    partial_write_then_kill,
    poison_chunks,
    poison_rows,
    sigkill_self,
    sigstop_self,
    sleep_forever,
    snapshot_paths,
    truncate_file,
    wedge_at_chunk,
)
