"""Multi-rank rendering over torch.distributed: one process a card.

`distributed.py` joins or starts the ranks (`init_distributed`, `spawn`)
and gives each rank its device; `sharding.py` holds a rank's share of a
chunk and the collectives of a render (the estimates' all-gather, the
counters' sum) and of a gradient step (`all_reduce_grads`). The port of
`yart_tpu/parallel/`, whose JAX mesh becomes processes that share nothing
but collectives."""
