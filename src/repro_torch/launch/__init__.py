"""Process entry points of the port: the cluster runtime's worker
(``launch.workers``)."""
