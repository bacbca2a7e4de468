"""Step builders and launchers (twin of ``repro/launch``): the train step,
the training launcher and the serving launcher.  The shardings, the serving
step builders, the mesh and the dry run come with the port's sharding."""
