"""Data and tensor parallelism over ranks (`mesh.py`: the mesh, the
collectives and the global batch's draws; `tensor.py`: the Megatron layout
of the models; `ranks.py`: rank programs started as processes)."""
