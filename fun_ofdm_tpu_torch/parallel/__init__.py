"""Multi-device receive over torch.distributed (fun_ofdm_tpu/parallel).

`mesh.make_mesh` lays the ranks out on a (channel, time) grid;
`stream_shard.sharded_receive` and `sharded_receive_dynamic` decode a
capture cut into one block per rank, with a right-neighbour halo and
exactly-once ownership; `distributed` brings the process group up and
places each rank's block; `python -m fun_ofdm_tpu_torch.parallel.dryrun`
runs both receives across N spawned ranks. One rank drives one device.
"""
