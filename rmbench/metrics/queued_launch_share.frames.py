"""queued_launch_share.frames: `queued_launch_share.mega_paths`'s share
in a frames cell's window: of the program's `rmr_mega_paths` launch
spans, the share that start inside its `rmr.pixel_queue` spans (0.0 where
a frame's launch runs one lane per pixel, as at 128 paths a lane).  The
same reader, declared apart because the frames cells report another
end-to-end metric."""
from pathlib import Path

from rmbench.harness import load_module

read = load_module(
    Path(__file__).with_name("queued_launch_share.mega_paths.py"),
    "rmbench_metric_queued_launch_share_mega_paths").read
