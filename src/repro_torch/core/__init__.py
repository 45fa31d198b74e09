"""FD as collectives over a mesh of virtual peers: the score-list unit,
the merge schedules, the mesh and the FD / CN / CN* top-k."""
