"""The masked-GRU kernel's launch geometry (rvo3d_tpu_torch/ops/masked_gru.py
`launch_geometry`), which the CUDA launcher takes as it is: every batch row,
hidden unit and (tile, direction) item is covered exactly once, the shared
memory fits a Hopper block, the cluster divides the padded hidden size, and
every shape the previous one-block-per-tile kernel took still fits. That
the kernel's zero padding of the hidden units leaves the result is held on
a card (tests/test_torch_cuda.py, H = 32 and 100)."""

import pytest

from rvo3d_tpu_torch.ops import masked_gru as mg

BATCHES = [0, 1, 31, 2048, 4089, 65536]


@pytest.mark.parametrize("batch", BATCHES)
def test_geometry_covers_rows_units_and_work_once(batch):
    for hidden in range(1, mg.MAX_HIDDEN + 1):
        for ndirs in (1, 2):
            geo = mg.launch_geometry(batch, hidden, 9, ndirs, max_clusters=16)
            assert geo.smem_bytes <= 232448
            assert geo.hidden_pad >= hidden
            assert geo.hidden_pad % (8 * mg.CLUSTER) == 0   # 8-unit groups per CTA
            assert geo.hidden_pad - hidden < 8 * mg.CLUSTER
            assert geo.rows in mg.ROW_CHOICES
            units = [u for q in range(mg.CLUSTER) for u in geo.units_of(q)]
            assert units == list(range(hidden))
            rows = [r for t in range(geo.tiles) for r in geo.rows_of(t)]
            assert rows == list(range(batch))
            work = sorted(w for c in range(geo.clusters) for w in geo.work_of(c))
            assert work == [(t, d) for t in range(geo.tiles) for d in range(ndirs)]
            assert geo.clusters <= 16
            if batch:
                assert geo.clusters >= 1
            shares = [len(geo.work_of(c)) for c in range(geo.clusters)]
            if batch:
                assert max(shares) - min(shares) <= 1      # balanced
            for c in range(geo.clusters):
                # a cluster loads a direction's weights at most once each
                dirs = [d for _, d in geo.work_of(c)]
                assert dirs == sorted(dirs)


@pytest.mark.parametrize("hidden", [1, 9, 32, 64, 65, 100, 128, 200, 256])
def test_every_shape_of_the_one_block_kernel_still_fits(hidden):
    """The previous kernel took H <= 256 and any IN with
    4 * (36 H + 32 IN + 32) <= 48 KiB; each such IN still has a tile."""
    max_in = (12288 - 32 - 36 * hidden) // 32
    for in_dim in sorted({1, 9, max_in // 2, max_in}):
        geo = mg.launch_geometry(4096, hidden, in_dim, 2, max_clusters=16)
        assert geo.smem_bytes <= 232448


def test_geometry_prefers_the_measured_tile_and_follows_the_card():
    geo = mg.launch_geometry(4096, 256, 9, 2, max_clusters=16)
    assert geo.rows == mg.ROW_CHOICES[0] == 48
    assert geo.units == 32 and geo.tiles == 86 and geo.clusters == 16
    assert mg.launch_geometry(4096, 256, 9, 2, max_clusters=15).clusters == 15
    assert mg.launch_geometry(4096, 256, 9, 2, max_clusters=1).clusters == 1
    assert mg.launch_geometry(1, 256, 9, 2, max_clusters=16).clusters == 2
    assert mg.smem_bytes(256, 9, 48) <= 232448
    assert mg.smem_bytes(256, 9, 64) > 232448      # two carries of 64 rows do not fit
    # IN so large that 48 rows no longer fit: smaller tiles
    assert mg.launch_geometry(4096, 256, 100, 1).rows == 32
    assert mg.launch_geometry(4096, 256, 200, 1).rows == 16


def test_geometry_refuses_what_the_kernel_does_not_take():
    for args, match in [((8, mg.MAX_HIDDEN + 1, 9), "H <="),
                        ((8, 0, 9), "H <="),
                        ((8, 256, 0), "bad shape"),
                        ((-1, 256, 9), "bad shape"),
                        ((8, 256, 9, 3), "bad shape"),
                        ((8, 256, 4000), "shared memory"),
                        ((8, 256, 9, 1, 0), "no cluster")]:
        with pytest.raises(ValueError, match=match):
            mg.launch_geometry(*args)
