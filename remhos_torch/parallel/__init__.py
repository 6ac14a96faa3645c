"""Element-sharded runs over `torch.distributed`: the port of
`remhos_tpu.parallel`.

The JAX package decomposes the elements over a device mesh inside one
`shard_map` program, exchanges a one-element-deep halo with `ppermute` and
reduces global scalars with `psum`/`pmin`. Here every shard is a process
(a rank) of a process group, with its own operator over its block of
elements:

- `halo.py`: the rank's place in the shard grid, the halo slab exchange
  (one `batch_isend_irecv` per exchange) and the global reductions;
- `sharded.py`: the structured route, blocks along the last mesh axes
  (the reference's METIS decomposition on a grid, remhos.cpp:459-463);
- `gsharded.py`: the general route, Morton-ordered blocks with ghost
  padding, for general meshes and for counts that do not divide the grid;
- `launch.py`: starting the ranks (`spawn_run`), which `shard_map` needs
  no counterpart of.

Sharded and unsharded runs agree to round-off: the sums over ranks round
differently from one sum.
"""
