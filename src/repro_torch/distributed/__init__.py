"""Distribution for the port: process groups (`group`), the partition
rules over a mesh (`sharding`) and the activation constraints
(`constraints`)."""
