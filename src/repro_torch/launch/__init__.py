"""Step builders and launchers (twin of ``repro/launch``): the train step
and the training launcher.  The shardings, the serving step builders, the
mesh and the dry run come with the port's sharding."""
