"""Scale-out: scenario data parallelism over a `torch.distributed` process
group, one rank per device."""
