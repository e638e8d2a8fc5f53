"""The reference's objectives, one module a family of configurations
(``config["family"]``), each with a class ``Objective`` that
``objective.build`` loads from its file: a new family is a new file here."""
