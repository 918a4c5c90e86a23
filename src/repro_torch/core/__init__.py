"""CPQ-aware path indexing (CPQx) on a torch device: the capacity-padded
relational substrate, Algorithm 1's k-path-bisimulation, Algorithm 2's
index assembly, interest-aware iaCPQx (Sec. V), lazy maintenance on a
host mirror flushed to the device (Sec. IV-E, V-C), the host-side
planner and optimizer, the plan walker and the union executable under
the overflow ladder, RPQ fixpoints and the openCypher subset, and the
serving layer with workload-driven interest adaptation."""
