"""Training substrate of the port: AdamW (``optim``), LR schedules
(``schedules``) and the fault-tolerant loop (``loop``)."""
